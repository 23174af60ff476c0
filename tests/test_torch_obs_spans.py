"""The port's wall-clock spans (``repro_torch.obs.spans``) on the CPU.

Off (no torch profiler recording) a span site opens no
``record_function`` and records nothing.  On, under ``torch.profiler``,
spans land in the profiler's events and in a bounded ring, nested and in
order; ``Engine.submit`` records its seven ``engine.*`` spans inside the
submit's interval; a reduced falcon-mamba-7b prefill records one
``model.layer`` span a layer, between the embedding's and the final
norm's and head's, and its logits are the same bit for bit with spans on
and off.
"""
import os
import time
import warnings

import pytest

torch = pytest.importorskip("torch")
# torch's intra-op threads: this pytest-xdist worker's share of the cores
torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", 1))))

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.cluster.topology import two_pod_cells  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.obs import Obs, spans  # noqa: E402
from repro_torch.platform import Platform  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from repro_torch.train.step import make_prefill_step  # noqa: E402

ENGINE = ["engine.health", "engine.policy", "engine.schedule",
          "engine.allocate", "engine.run", "engine.release", "engine.bind"]


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.fixture(autouse=True)
def empty_ring():
    spans.clear()
    yield
    spans.clear()


def _falcon():
    cfg = ARCHS["falcon-mamba-7b"].reduced()
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab, (1, 24),
                           generator=torch.Generator().manual_seed(1))
    return cfg, model, {"tokens": tokens}


def test_off_opens_no_range_and_records_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with spans off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert spans.span("a") is spans.span("b")  # one shared no-op
    with spans.span("engine.run"):
        with spans.span("model.layer"):
            pass
    cfg, model, batch = _falcon()
    make_prefill_step(cfg)(model, batch)
    assert spans.records() == [] and spans.dropped() == 0


def test_on_spans_are_nested_ordered_and_in_the_profile():
    with _profiled() as prof:
        with spans.span("outer"):
            with spans.span("inner.a"):
                torch.ones(4).add_(1)
            with spans.span("inner.b"):
                torch.ones(4).mul_(2)
    got = spans.records()
    # in the order they close: the nested ones first
    assert [r[0] for r in got] == ["inner.a", "inner.b", "outer"]
    a, b, outer = got
    assert all(r[1] <= r[2] for r in got)
    assert _inside(a, outer) and _inside(b, outer) and a[2] <= b[1]
    names = {e.name for e in prof.events()}
    assert {"outer", "inner.a", "inner.b"} <= names
    # the profiler off again: the ring is left as it was
    with spans.span("after"):
        pass
    assert spans.records() == got


def test_the_ring_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(spans, "RING", spans.SpanRing(capacity=4))
    plat = Platform(cluster={"w0": 8.0}, device="cpu", obs=Obs())
    with _profiled():
        for i in range(6):
            with spans.span(f"s{i}"):
                pass
    assert [r[0] for r in spans.records()] == ["s2", "s3", "s4", "s5"]
    assert spans.dropped() == 2
    snap = plat.obs.snapshot()
    assert (snap["spans.records"], snap["spans.dropped"]) == (4, 2)
    spans.clear()
    assert spans.records() == [] and spans.dropped() == 0
    assert plat.obs.snapshot()["spans.dropped"] == 0


def test_engine_submit_records_its_seven_spans_in_order():
    cells = two_pod_cells()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        eng = Engine(cells, runner=lambda req, cell: 7, device="cpu")
    eng.deploy("m", ["pod0-cell0", "pod1-cell0"], weights_gb=8)
    with _profiled():
        t_s = time.perf_counter_ns()
        comp = eng.submit(Request(model="m", kind="prefill", session="s0"))
        t_d = time.perf_counter_ns()
    assert comp.ok and comp.result == 7
    got = sorted((r for r in spans.records() if r[0].startswith("engine.")),
                 key=lambda r: r[1])
    assert [r[0] for r in got] == ENGINE
    assert all(t_s <= r[1] <= r[2] <= t_d for r in got)
    assert all(x[2] <= y[1] for x, y in zip(got, got[1:]))


def test_mamba_prefill_spans_and_bit_identical_logits():
    cfg, model, batch = _falcon()
    step = make_prefill_step(cfg)
    off = step(model, batch)
    assert spans.records() == []
    with _profiled():
        on = step(model, batch)
    assert torch.equal(off, on)
    got = sorted(spans.records(), key=lambda r: r[1])
    assert [r[0] for r in got] == (
        ["model.embed"] + ["model.layer"] * cfg.n_layers
        + ["model.final_norm", "model.head"])
    assert all(x[2] <= y[1] for x, y in zip(got, got[1:]))
