"""The port's observability plane against the JAX reference's.

The port's ``Platform`` on ``device="cpu"`` with an ``Obs`` bundle attached
must decide exactly as without one (decisions and rng draws, as
``tests/test_obs.py`` holds the reference), and its tracer must write the
reference's decision log byte for byte, the reference on its float32
``backend="ref"``; the registry's snapshot keys, the metrics, the Chrome
trace validator, the SLO engine and latency attribution give the
reference's results on the same inputs; ``serve.Engine``'s records are the
same with a bundle attached.
"""
import math
import os
import random
import warnings

import pytest

torch = pytest.importorskip("torch")
# torch's intra-op threads: this pytest-xdist worker's share of the cores
torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", 1))))

import repro.obs as ref_obs  # noqa: E402
from repro.cluster.topology import two_pod_cells as ref_cells  # noqa: E402
from repro.cluster.topology import zone_map as ref_zone_map  # noqa: E402
from repro.platform import Platform as RefPlatform  # noqa: E402
from repro.pool import StartCosts as RefStartCosts  # noqa: E402
from repro.pool import WarmPool as RefWarmPool  # noqa: E402
from repro.pool import make_policy as ref_make_policy  # noqa: E402
from repro.serve.engine import Engine as RefEngine  # noqa: E402
from repro.serve.engine import Request as RefRequest  # noqa: E402
from repro.workload import InvocationRecord as RefRecord  # noqa: E402
import repro_torch.obs as port_obs  # noqa: E402
from repro_torch.cluster.topology import two_pod_cells, zone_map  # noqa: E402
from repro_torch.obs import Obs  # noqa: E402
from repro_torch.platform import Platform  # noqa: E402
from repro_torch.pool import StartCosts, WarmPool, make_policy  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from repro_torch.workload import InvocationRecord  # noqa: E402
from test_torch_serve import drive  # noqa: E402

# tests/test_obs.py's script: anti-affinity, an affine tag with a failing
# followup, a pinned heavy
SCRIPT = """
d:
  workers: *
  strategy: best_first
  affinity: [!h]
i:
  - workers: *
    strategy: best_first
    affinity: [d]
  - followup: fail
h:
  workers: [w2]
"""

# a zoned cluster whose script routes: the sharded plane's route spans
ZONED_SCRIPT = """
d:
  workers: *
  strategy: best_first
  topology: local_first
i:
  workers: *
  strategy: warmest
  affinity: [d]
  topology: local_first
"""


def _pool(port):
    cls, costs, policy = ((WarmPool, StartCosts, make_policy) if port else
                          (RefWarmPool, RefStartCosts, ref_make_policy))
    return cls(policy("fixed_ttl", ttl=100.0),
               costs=costs(cold=0.5, warm=0.1, hot=0.0), budget_mb=64.0,
               hot_window=100.0)


def _platform(port, script=SCRIPT, cluster=None, **kw):
    cluster = cluster or {"w0": 8.0, "w1": 8.0, "w2": 8.0}
    if port:
        plat = Platform.from_yaml(script, cluster=cluster, device="cpu", **kw)
    else:
        plat = RefPlatform.from_yaml(script, cluster=cluster, backend="ref",
                                     **kw)
    plat.register("divide", memory=1.0, tag="d")
    plat.register("impera", memory=1.0, tag="i")
    if script is SCRIPT:
        plat.register("heavy", memory=4.0, tag="h")
    return plat


def _drive(plat, n=40, fns=("divide", "impera", "heavy")):
    """``tests/test_obs.py``'s loop: invoke, complete, and the rng's next
    draws (a traced run must consume exactly the untraced run's draws)."""
    rng = random.Random(7)
    mix = random.Random(11)
    out = []
    for i in range(n):
        f = mix.choice(fns)
        if plat.state.zones() != ("",):
            d = plat.invoke(f, rng, zone=mix.choice(plat.state.zones()))
        else:
            d = plat.invoke(f, rng)
        out.append((f, d.worker, d.start_kind))
        if plat._owns_clock:
            plat.advance(0.25)
        if d.worker is not None and i % 3:
            plat.complete(d)
    return out, [rng.random() for _ in range(3)]


def _ref_obs(**kw):
    return ref_obs.Obs.enabled(**kw)


def test_obs_exports_equal_the_reference():
    assert port_obs.__all__ == ref_obs.__all__
    assert port_obs.RECORD_FIELDS == ref_obs.RECORD_FIELDS
    assert port_obs.COMPONENTS == ref_obs.COMPONENTS
    assert port_obs.LATENCY_BOUNDS_S == ref_obs.LATENCY_BOUNDS_S


@pytest.mark.parametrize("verdicts", [False, True])
def test_tracing_is_bit_identical(verdicts):
    plain = _drive(_platform(True, pool=_pool(True)))
    obs = Obs.enabled(verdicts=verdicts)
    traced = _drive(_platform(True, pool=_pool(True), obs=obs))
    assert plain == traced
    assert len(obs.tracer.events) > 0
    assert plain == _drive(_platform(False, pool=_pool(False)))


@pytest.mark.parametrize("verdicts", [False, True])
def test_decision_log_equals_the_reference(verdicts):
    obs = Obs.enabled(verdicts=verdicts)
    ref = _ref_obs(verdicts=verdicts)
    got = _drive(_platform(True, pool=_pool(True), obs=obs))
    want = _drive(_platform(False, pool=_pool(False), obs=ref))
    assert got == want
    assert obs.tracer.to_jsonl() == ref.tracer.to_jsonl()
    trace = obs.tracer.chrome_trace()
    assert trace == ref.tracer.chrome_trace()
    assert port_obs.validate_chrome_trace(trace) == []


def _shared(snap):
    """A snapshot without the port's own ``spans.*`` collector keys (the
    wall-clock span ring, ``repro_torch.obs.spans``, which the reference
    does not have)."""
    return {k: v for k, v in snap.items() if not k.startswith("spans.")}


def _stable(snap):
    """A shared snapshot without the stage timers' wall-clock values (their
    counts stay: the sampling gate is a deterministic counter)."""
    return {k: v for k, v in _shared(snap).items()
            if not (k.startswith("sched.stage.") and not k.endswith(".count"))}


def test_sharded_route_log_equals_the_reference():
    """A routed script on a zoned cluster: the sharded router's route
    spans and shard counters, traced, against the reference's."""
    def zoned(port, obs):
        cluster = {f"w{i}": 8.0 for i in range(6)}
        zones = {f"w{i}": ("eu", "us", "ap")[i % 3] for i in range(6)}
        return _platform(port, ZONED_SCRIPT, cluster, zones=zones,
                         pool=_pool(port), obs=obs)

    obs, ref = Obs.enabled(verdicts=True), _ref_obs(verdicts=True)
    got = _drive(zoned(True, obs), fns=("divide", "impera"))
    want = _drive(zoned(False, ref), fns=("divide", "impera"))
    assert got == want
    assert obs.tracer.to_jsonl() == ref.tracer.to_jsonl()
    assert "route" in {r["kind"] for r in obs.tracer.records()}
    assert _stable(obs.snapshot()) == _stable(ref.snapshot())


def test_snapshot_keys_equal_the_reference():
    obs, ref = Obs.enabled(timers=True), _ref_obs(timers=True)
    p = _platform(True, pool=_pool(True), obs=obs)
    r = _platform(False, pool=_pool(False), obs=ref)
    assert _drive(p, n=300) == _drive(r, n=300)
    snap, want = obs.snapshot(), ref.snapshot()
    assert list(_shared(snap)) == list(want)
    assert {"spans.records", "spans.dropped"} == set(snap) - set(want)
    assert _stable(snap) == _stable(want)
    assert snap["sched.stage.mask_build_s.count"] > 0
    assert p.stats() == r.stats()


def test_attach_detach_round_trip():
    obs = Obs.enabled()
    plat = _platform(True)
    plat.attach_obs(obs)
    plat.invoke("divide", random.Random(0))
    n = len(obs.tracer.events)
    assert n > 0
    plat.attach_obs(None)
    plat.invoke("divide", random.Random(0))
    assert len(obs.tracer.events) == n
    plat.attach_obs(obs)
    plat.invoke("divide", random.Random(0))
    assert len(obs.tracer.events) > n


def test_live_verdicts_agree_with_explain():
    """The traced block walk records, per block, each worker's verdict:
    ``explain()``'s verdicts on the same state (``tests/test_obs.py``)."""
    obs = Obs.enabled(verdicts=True)
    plat = _platform(True, pool=_pool(True), obs=obs)
    rng = random.Random(7)
    mix = random.Random(11)
    for _ in range(30):
        f = mix.choice(["divide", "impera", "heavy"])
        explained = plat.explain(f)
        d = plat.invoke(f, rng)
        rec = obs.tracer.records()[-2 if d.worker else -1]
        if rec["kind"] != "blocks":  # unschedulable with no pool acquire
            rec = next(r for r in reversed(obs.tracer.records())
                       if r["kind"] == "blocks")
        assert rec["function"] == f and rec["worker"] == explained.worker
        walked = dict(rec["verdicts"])
        assert len(walked) == len(explained.trace)
        for bt in explained.trace:
            assert walked[bt.index] == tuple(
                (v.worker, v.ok, v.reason) for v in bt.workers)
        if d.worker is not None:
            plat.complete(d)


def _metrics(m):
    reg = m.MetricsRegistry()
    reg.counter("requests").inc(5)
    reg.gauge("inflight").set(2.0)
    rng = random.Random(3)
    h = reg.histogram("lat_s")
    for _ in range(500):
        h.observe(rng.lognormvariate(-3.0, 2.0))
    reg.histogram("small_s", bounds=(0.001, 0.01, 0.1)).observe(5.0)
    reg.register_collector("pool", lambda: {"cold": 3, "by": {"eu": 1}})
    tm = m.StageTimers(reg, sample=4)
    fired = [tm.sample() for _ in range(9)]
    tm.observe("mask_build", 0.002)
    return (reg.snapshot(), reg.render(), fired,
            [h.quantile(q) for q in (0.0, 0.3, 0.5, 0.99, 1.0)])


def test_metrics_registry_equals_the_reference():
    assert _metrics(port_obs) == _metrics(ref_obs)


BROKEN_TRACES = [
    [],
    {"traceEvents": [{"ph": "?", "name": "x"}]},
    {"traceEvents": [
        {"ph": "i", "name": "a", "ts": 5, "s": "t", "pid": 1, "tid": 0},
        {"ph": "i", "name": "b", "ts": 1, "s": "t", "pid": 1, "tid": 0}]},
    {"traceEvents": [
        {"ph": "X", "name": "a", "ts": 1, "dur": -2, "pid": 1, "tid": 0}]},
    {"traceEvents": [{"ph": "B", "name": "a", "ts": 1, "pid": 1, "tid": 0}]},
    {"traceEvents": [
        {"ph": "B", "name": "a", "ts": 1, "pid": 1, "tid": 0},
        {"ph": "E", "name": "a", "ts": 2, "pid": 1, "tid": 0}]},
]


@pytest.mark.parametrize("case", range(len(BROKEN_TRACES)))
def test_chrome_trace_validator_equals_the_reference(case):
    obj = BROKEN_TRACES[case]
    assert port_obs.validate_chrome_trace(obj) == \
        ref_obs.validate_chrome_trace(obj)


def _slo(m):
    eng = m.SloEngine({"api": 0.5,
                       "etl": {"threshold_s": 2.0, "compliance": 0.9}})
    rng = random.Random(2)
    t = 0.0
    for _ in range(400):
        t += rng.expovariate(4.0)
        eng.observe(rng.choice(["api", "etl", "nope"]), t,
                    rng.lognormvariate(-1.0, 1.0))
    reg = m.MetricsRegistry()
    eng.register_into(reg)
    return (eng.snapshot(), reg.render(),
            [eng.budget_remaining(f) for f in ("api", "etl")])


def test_slo_engine_equals_the_reference():
    assert _slo(port_obs) == _slo(ref_obs)


def _attribution(m, record_cls):
    """Seeded component charges closed by ``build`` into records whose
    exact-sum invariant ``check`` holds, streamed into the attributor's
    histograms and summarised per function."""
    rng = random.Random(8)
    reg = m.MetricsRegistry()
    attr = m.LatencyAttributor(reg)
    records = []
    for i in range(200):
        parts = {k: rng.choice([0.0, rng.random(), 1e-17 * rng.random()])
                 for k in ("sched", "boot", "route", "service")}
        wait = rng.choice([0.0, rng.random()])
        latency = sum(parts.values()) + rng.choice([0.0, 1e-16])
        comps = m.build_attribution(migrate=0.0, parent_wait=wait,
                                    latency=latency, **parts)
        rec = record_cls(rng.choice(["api", "etl"]), "w0", wait, latency,
                         "cold", False, None, f"a{i}", 0.0, comps)
        m.check_attribution(rec)
        attr.observe(rec, zone=rng.choice([None, "eu"]))
        records.append(rec)
    return ([r.components for r in records], reg.snapshot(),
            m.summarize_attribution(records, by="function"))


def test_latency_attribution_equals_the_reference():
    got = _attribution(port_obs, InvocationRecord)
    assert got == _attribution(ref_obs, RefRecord)
    assert all(math.isfinite(sum(c.values())) for c in got[0])


def test_engine_records_are_unchanged_with_obs_attached():
    """``serve.Engine`` over a platform with a bundle attached: the same
    placements, relocations and homes as without one, and as the
    reference's engine with its bundle; its decision log equals the
    reference's."""
    def engine_run(port, obs):
        clock = [0.0]
        if port:
            cells = two_pod_cells()
            plat = Platform(cluster={n: s.hbm_gb for n, s in cells.items()},
                            zones=zone_map(cells), clock=lambda: clock[0],
                            seed=7, device="cpu", obs=obs)
            eng_cls, req_cls = Engine, Request
        else:
            cells = ref_cells()
            plat = RefPlatform(cluster={n: s.hbm_gb
                                        for n, s in cells.items()},
                               zones=ref_zone_map(cells),
                               clock=lambda: clock[0], seed=7,
                               backend="ref", obs=obs)
            eng_cls, req_cls = RefEngine, RefRequest

        def runner(req, cell):
            clock[0] += 0.01

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            return drive(eng_cls, req_cls, cells, runner, clock,
                         platform=plat)

    bare = engine_run(True, None)
    obs, ref = Obs.enabled(), _ref_obs()
    assert engine_run(True, obs) == bare
    assert engine_run(False, ref) == bare
    assert obs.tracer.to_jsonl() == ref.tracer.to_jsonl()
    assert len(obs.tracer.events) > 0
