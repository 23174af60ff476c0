"""The readers of the port's own spans (``decide_us``, ``engine_state_us``,
``short_layer_us``): a span counts for the profiled request whose interval
holds it, the layer reader takes requests under 1,024 tokens only, and
each reads nothing where the program recorded no span in a profiled
request or its ring dropped some.  Then one small traced run on the CPU
reads all three."""
import math
import os
import time
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", 1))))

from repro_torch.obs import spans  # noqa: E402

from bench.harness import results, spec  # noqa: E402
from bench.tests import small  # noqa: E402

READERS = ("decide_us", "engine_state_us", "short_layer_us")
US = 1000  # nanoseconds


def _rec(i, t_submit, t_done, length, profiled=True):
    return SimpleNamespace(index=i, t_submit=t_submit, t_done=t_done,
                           length=length, profiled=profiled)


def _read(name, ctx):
    return spec.metric_reader(name).read(ctx)


@pytest.fixture
def ring(monkeypatch):
    r = spans.SpanRing()
    monkeypatch.setattr(spans, "RING", r)
    return r


def _request(ring, t0_s, decide, state, layers):
    """Spans of one request starting at ``t0_s`` seconds: ``decide`` and
    ``state`` us split over their engine spans, then ``layers`` model.layer
    spans of the given us, back to back."""
    t = int(t0_s * 1e9) + 5 * US
    parts = [("engine.health", state / 4), ("engine.policy", decide / 2),
             ("engine.schedule", decide / 2), ("engine.allocate", state / 4)]
    parts += [("model.layer", us) for us in layers]
    parts += [("engine.release", state / 4), ("engine.bind", state / 4)]
    for name, us in parts:
        ring.append(name, t, t + int(us * US))
        t += int(us * US) + US


def test_spans_count_for_the_profiled_request_that_holds_them(ring):
    recs = [_rec(0, 1.0, 1.1, 300, profiled=False),
            _rec(1, 2.0, 2.1, 500), _rec(2, 3.0, 3.1, 4000),
            _rec(3, 4.0, 4.1, 900)]
    _request(ring, 1.0, 999, 999, [999])  # the window's: not profiled
    _request(ring, 2.0, 400, 200, [100, 300])
    _request(ring, 3.0, 600, 400, [5000])
    _request(ring, 4.0, 500, 300, [200])
    ring.append("engine.policy", int(5.0e9), int(5.001e9))  # no request's
    ring.append("engine.policy", int(4.09e9), int(4.2e9))  # past t_done
    ctx = SimpleNamespace(records=recs)
    assert _read("decide_us", ctx) == pytest.approx((400 + 600 + 500) / 3)
    assert _read("engine_state_us", ctx) == pytest.approx(
        (200 + 400 + 300) / 3)
    # requests 1 and 3 are under 1,024 tokens: their three layers
    assert _read("short_layer_us", ctx) == pytest.approx(
        (100 + 300 + 200) / 3)


def test_no_spans_read_nothing(ring):
    recs = [_rec(0, 2.0, 2.1, 500), _rec(1, 3.0, 3.1, 4000)]
    ctx = SimpleNamespace(records=recs)
    assert all(_read(n, ctx) is None for n in READERS)
    _request(ring, 3.0, 600, 400, [5000])  # a long request only
    assert _read("decide_us", ctx) == pytest.approx(600)
    assert _read("short_layer_us", ctx) is None
    # spans, but none in a profiled request
    recs[1].profiled = False
    assert all(_read(n, ctx) is None for n in READERS)


def test_a_ring_that_dropped_spans_reads_nothing(monkeypatch):
    r = spans.SpanRing(capacity=7)
    monkeypatch.setattr(spans, "RING", r)
    _request(r, 2.0, 400, 200, [100, 300])  # 8 spans into 7
    assert r.dropped_spans == 1
    ctx = SimpleNamespace(records=[_rec(0, 2.0, 2.1, 500)])
    assert all(_read(n, ctx) is None for n in READERS)


def test_a_small_traced_run_reads_all_three():
    spans.clear()
    cell = small.CELLS["falcon-mamba-7b.prefill"]
    out = results.run_cell(spec.benchmark(), cell, seed=2**31 + 5,
                           seconds=0.3, trace=True,
                           device=torch.device("cpu"),
                           t_start=time.perf_counter(),
                           config=small.config(cell["config"]),
                           mix=small.mix(), limits=small.LIMITS)
    assert out["correct"], out["checks"]
    for name in READERS:
        value = out["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0, (name, value)
    assert spans.dropped() == 0
    spans.clear()
