"""The port's discrete-event simulator and workload driver against the JAX
reference's.

The same trace, scripts and seeds go through ``repro_torch`` (decisions on
``device="cpu"``: the affinity kernels' plain PyTorch versions) and through
``repro``; every comparison is exact: records (``repr``, so NaN latencies
of failed records compare too), rng draws and decision logs byte for byte.
Covers both compute cores on the four workload scenarios, the closed-loop
divide-et-impera workload, the wave-batched driver, ``run_config`` /
``replay_identical`` / ``whatif``, and ``chip_smoke``'s trace path (runs A
and B) at a reduced cluster.
"""
import os
import random

import pytest

torch = pytest.importorskip("torch")
# torch's intra-op threads: this pytest-xdist worker's share of the cores
torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", 1))))

from benchmarks.affinity_case_study import AAPP_SCRIPT  # noqa: E402
from repro.cluster.divide_impera import DivideImperaWorkload as RefDivide  # noqa: E402
from repro.cluster.simulator import ClusterSim as RefSim  # noqa: E402
from repro.cluster.simulator import SimParams as RefParams  # noqa: E402
from repro.cluster.topology import paper_testbed as ref_testbed  # noqa: E402
from repro.core import SchedulerSession as RefSession  # noqa: E402
from repro.core import parse as ref_parse  # noqa: E402
from repro.core import try_schedule as ref_try_schedule  # noqa: E402
from repro.platform import Platform as RefPlatform  # noqa: E402
from repro.pool import StartCosts as RefStartCosts  # noqa: E402
from repro.pool import WarmPool as RefWarmPool  # noqa: E402
from repro.pool import make_policy as ref_make_policy  # noqa: E402
from repro.workload import Arrival as RefArrival  # noqa: E402
from repro.workload import ReplayConfig as RefConfig  # noqa: E402
from repro.workload import TraceWorkload as RefWorkload  # noqa: E402
from repro.workload import build_trace as ref_build_trace  # noqa: E402
from repro.workload import register_functions as ref_register  # noqa: E402
from repro.workload import run_config as ref_run_config  # noqa: E402
from repro.workload import whatif as ref_whatif  # noqa: E402
from repro.workload.replay import chrome_trace as ref_chrome_trace  # noqa: E402
from repro_torch.cluster.divide_impera import DivideImperaWorkload  # noqa: E402
from repro_torch.cluster.simulator import ClusterSim, SimParams  # noqa: E402
from repro_torch.cluster.topology import paper_testbed  # noqa: E402
from repro_torch.core import SchedulerSession, parse, try_schedule  # noqa: E402
from repro_torch.platform import Platform  # noqa: E402
from repro_torch.pool import StartCosts, WarmPool, make_policy  # noqa: E402
from repro_torch.workload import (COMPUTE_S, SCENARIOS, Arrival, ReplayConfig,  # noqa: E402
                                  TraceWorkload, build_trace,
                                  register_functions, replay_identical,
                                  run_config, validate_replay_timeline,
                                  whatif)
from repro_torch.workload.replay import chrome_trace  # noqa: E402

import chip_smoke  # noqa: E402

# tests/test_simulator_engines.py's script: every tag random (rng draws on
# every decision), i affine to d
SCRIPT = """
api:
  workers: *
  strategy: random
img:
  workers: *
  strategy: random
etl:
  workers: *
  strategy: random
d:
  workers: *
  strategy: random
i:
  workers: *
  strategy: random
  affinity: [d]
"""

ENGINES = ("legacy", "virtual")


def _reprs(records):
    return [repr(r) for r in records]


def _port_trace(scenario, engine, *, duration=40.0, rate=2.0, seed=0):
    sim = ClusterSim(paper_testbed(), SimParams(), seed=seed, engine=engine)
    register_functions(sim.registry)
    script = parse(SCRIPT)
    rng = random.Random(seed + 1)
    session = SchedulerSession(sim.state, sim.registry, script,
                               clock=lambda: sim.now, device="cpu")
    wl = TraceWorkload(sim, lambda f: session.try_schedule(f, rng=rng),
                       COMPUTE_S, script=script)
    wl.load(build_trace(scenario, duration=duration, rate=rate, seed=seed))
    sim.run()
    return sim, wl, rng


def _ref_trace(scenario, engine, *, duration=40.0, rate=2.0, seed=0):
    sim = RefSim(ref_testbed(), RefParams(), seed=seed, engine=engine)
    ref_register(sim.registry)
    script = ref_parse(SCRIPT)
    rng = random.Random(seed + 1)
    session = RefSession(sim.state, sim.registry, script,
                         clock=lambda: sim.now, backend="ref")
    wl = RefWorkload(sim, lambda f: session.try_schedule(f, rng=rng),
                     COMPUTE_S, script=script)
    wl.load(ref_build_trace(scenario, duration=duration, rate=rate,
                            seed=seed))
    sim.run()
    return sim, wl, rng


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_scenario_records_equal_the_reference(scenario, engine):
    sim, wl, rng = _port_trace(scenario, engine)
    ref_sim, ref_wl, ref_rng = _ref_trace(scenario, engine)
    assert wl.records
    assert _reprs(wl.records) == _reprs(ref_wl.records)
    assert rng.random() == ref_rng.random()
    assert sim.stats == ref_sim.stats


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_engines_agree_and_conserve_work(scenario):
    """The port's two processor-sharing cores: the same placements and
    start kinds, latencies within float noise, no more completion events
    on the virtual core, and per-worker delivered work equal to the work
    submitted on both (``tests/test_simulator_engines.py``)."""
    runs = {e: _port_trace(scenario, e) for e in ENGINES}
    (lg_sim, lg_wl, _), (vt_sim, vt_wl, _) = runs["legacy"], runs["virtual"]
    assert [(r.function, r.worker, r.start_kind) for r in lg_wl.records] == \
        [(r.function, r.worker, r.start_kind) for r in vt_wl.records]
    for a, b in zip(lg_wl.records, vt_wl.records):
        assert a.latency == pytest.approx(b.latency, abs=1e-9)
    assert (vt_sim.stats["completion_pushes"]
            <= lg_sim.stats["completion_pushes"])
    for sim, _wl, _rng in runs.values():
        assert not sim.has_compute()
        total = 0.0
        for w in sim.workers:
            d, s = sim.delivered_work(w), sim.submitted_work(w)
            total += s
            assert d == pytest.approx(s, rel=1e-9, abs=1e-9), (w, d, s)
        assert total > 0.0


def _divide_results(sim_cls, params_cls, testbed, workload_cls, parse_fn,
                    schedule, seed=1, runs=3, divides=8):
    """``tests/test_engine_and_sim.py``'s case study loop: per run two
    heavies and a chain of divides, each divide spawning two imperas."""
    script = parse_fn(AAPP_SCRIPT)
    sim = sim_cls(testbed(), params_cls(), seed=seed)
    rng = random.Random(seed)
    wl = workload_cls(sim, lambda f: schedule(
        f, sim.state.conf(), script, sim.registry, rng=rng))

    def start_run(i):
        if i >= runs:
            return
        done = {"h": 0, "d": 0}

        def nxt():
            if done["h"] == 2 and done["d"] == divides:
                start_run(i + 1)

        def hd():
            done["h"] += 1
            nxt()

        wl.submit_heavy("heavy_eu", hd)
        wl.submit_heavy("heavy_us", hd)

        def dd(_):
            done["d"] += 1
            if done["d"] < divides:
                wl.submit_divide(dd)
            else:
                nxt()

        wl.submit_divide(dd)

    start_run(0)
    sim.run()
    return [repr(r) for r in wl.results], rng.random()


def test_divide_impera_results_equal_the_reference():
    got = _divide_results(ClusterSim, SimParams, paper_testbed,
                          DivideImperaWorkload, parse, try_schedule)
    want = _divide_results(RefSim, RefParams, ref_testbed, RefDivide,
                           ref_parse, ref_try_schedule)
    assert got[0]
    assert got == want


def _wave_sim_records(batched, *, port=True, bursts=12, sizes=(1, 3, 4)):
    """``tests/test_bulk_wave.py``'s wave-batching rig: bursts of
    same-tick arrivals and singletons on the paper testbed."""
    mk = (ClusterSim, SimParams, paper_testbed, register_functions, Platform,
          TraceWorkload, Arrival) if port else (
        RefSim, RefParams, ref_testbed, ref_register, RefPlatform,
        RefWorkload, RefArrival)
    sim_cls, params, testbed, register, plat_cls, wl_cls, arrival = mk
    sim = sim_cls(testbed(), params(), seed=0)
    register(sim.registry)
    kw = {"device": "cpu"} if port else {}
    plat = plat_cls.for_sim(
        sim, "api:\n  workers: *\nimg:\n  workers: *\netl:\n  workers: *\n",
        **kw)
    rng = random.Random(1)
    mix = random.Random(4)
    trace = []
    t = 0.0
    for _ in range(bursts):
        n = mix.choice(sizes)
        for _ in range(n):
            trace.append(arrival(t=t, function=mix.choice(
                ["api", "thumb", "etl"])))
        t += mix.choice([0.5, 1.0])
    wl = wl_cls(sim, plat.placer(rng), COMPUTE_S, script=plat.script,
                batcher=plat.batch_placer(rng) if batched else None)
    wl.load(trace)
    sim.run()
    plat.close()
    return _reprs(wl.records), rng.random()


def test_wave_batched_driver_equals_the_sequential_drivers():
    """The port's wave batcher, record for record and rng draw for rng
    draw, against the port's per-arrival driver and the reference's."""
    batched = _wave_sim_records(True)
    assert batched[0]
    assert batched == _wave_sim_records(False)
    assert batched == _wave_sim_records(False, port=False)
    assert batched == _wave_sim_records(True, port=False)


EVICT_SCRIPT = """
api:
  workers: *
  strategy: best_first
etl:
  workers: *
  strategy: best_first
"""


def _evict_rig(port: bool):
    """Two workers at t = 5.5: ``a`` holds two idle ``api`` containers,
    one idle since 0 (warm: the one the keep-alive policy serves) and one
    since 5 (hot); ``b`` holds one hot ``api`` container.  An ``etl`` cold
    start on ``a`` must evict the older ``api`` container to fit the
    384 MB budget, after which ``a`` serves ``api`` hot."""
    plat_cls, pool_cls, costs, policy = (
        (Platform, WarmPool, StartCosts, make_policy) if port else
        (RefPlatform, RefWarmPool, RefStartCosts, ref_make_policy))
    pool = pool_cls(policy("fixed_ttl", ttl=100.0),
                    costs=costs(cold=0.5, warm=0.1, hot=0.0),
                    budget_mb=384.0, hot_window=1.0)
    kw = {"device": "cpu"} if port else {"backend": "ref"}
    plat = plat_cls(EVICT_SCRIPT, cluster={"a": 1024.0, "b": 1024.0},
                    pool=pool, **kw)
    plat.register("api", memory=128.0, tag="api")
    plat.register("etl", memory=256.0, tag="etl")
    old, new = (pool.acquire("api", "a", 0.0, memory=128.0, tag="api")[0]
                for _ in range(2))
    pool.release(old.cid, 0.0)
    pool.release(new.cid, 5.0)
    held = pool.acquire("api", "b", 0.0, memory=128.0, tag="api")[0]
    pool.release(held.cid, 5.0)
    plat.advance(5.5)
    assert (pool.warmth("api", "a", 5.5), pool.warmth("api", "b", 5.5)) \
        == (1, 2)
    return plat


def test_wave_rechecks_a_worker_whose_cold_start_made_it_hotter():
    """A live wave where a cold start evicts a worker's older idle
    container of another function, so that worker's warmth rank for it
    rises mid-wave.  The port's wave re-checks each committed worker and
    decides as a loop of ``invoke`` does (``a``, now hot and first),
    where the reference's wave defers ``a`` and picks ``b``."""
    def fingerprint(ds):
        return [(d.worker, d.start_kind) for d in ds]

    requests = ["etl", "api"]
    port, ref = _evict_rig(True), _evict_rig(False)
    seq = fingerprint([port.invoke(f, random.Random(0)) for f in requests])
    assert seq == [("a", "cold"), ("a", "hot")]
    assert fingerprint([ref.invoke(f, random.Random(0))
                        for f in requests]) == seq
    assert fingerprint(_evict_rig(True).decide_batch(
        requests, random.Random(0))) == seq


@pytest.mark.parametrize("strategy", ["best_first", "warmest",
                                      "least_loaded"])
def test_run_config_equals_the_reference(strategy):
    """Records, rng tail and decision log of one captured run; the
    reference on its default float64 ``np`` backend (these strategies have
    no ``min_cost`` tie for float32 to break)."""
    cfg = dict(scenario="chained", strategy=strategy, duration=120.0,
               rate=2.0, seed=3)
    got = run_config(ReplayConfig(**cfg), device="cpu")
    want = ref_run_config(RefConfig(**cfg))
    assert got.records
    assert _reprs(got.records) == _reprs(want.records)
    assert got.rng_tail == want.rng_tail
    assert got.jsonl == want.jsonl
    assert chrome_trace(got) == ref_chrome_trace(want)


def test_multiregion_run_config_equals_the_reference():
    """The sharded router (three zones, ``local_first``) under replay."""
    cfg = dict(scenario="multiregion", duration=60.0, rate=2.0, seed=1)
    got = run_config(ReplayConfig(**cfg), device="cpu")
    want = ref_run_config(RefConfig(**cfg))
    assert got.records
    assert _reprs(got.records) == _reprs(want.records)
    assert got.rng_tail == want.rng_tail
    assert got.jsonl == want.jsonl


def test_replay_is_identical_and_its_timeline_valid():
    cfg = ReplayConfig(scenario="poisson", duration=120.0, rate=2.0, seed=0)
    a = run_config(cfg, device="cpu")
    b = run_config(cfg, trace=a.trace, device="cpu")
    assert replay_identical(a, b) == []
    assert validate_replay_timeline(chrome_trace(a)) == []


def test_whatif_deltas_equal_the_reference():
    cfg = dict(scenario="bursty", duration=120.0, rate=2.0, seed=2)
    got = whatif(run_config(ReplayConfig(**cfg), device="cpu"),
                 strategy="least_loaded")
    want = ref_whatif(ref_run_config(RefConfig(**cfg)),
                      strategy="least_loaded")
    assert got.entries
    assert got.entries == want.entries
    assert got.component_deltas() == want.component_deltas()
    assert got.mean_delta() == want.mean_delta()
    assert got.alt.platform.session.device.type == "cpu"


def test_chip_smoke_trace_path_at_a_reduced_cluster():
    """``chip_smoke``'s phase 12 on the CPU at 8 testbed copies: run A
    (traced, resilience, zone outage) equal to its ``cpu`` and float64
    twins, with work conserved and every loss retried or counted; run B's
    waves equal to the per-arrival run and the twins, one fused pass a
    wave."""
    out = chip_smoke.trace_path(8, "cpu", min_arrivals=256, ticks=4,
                                per_tick=64)
    a, b = out["A"], out["B"]
    assert a["workers"] == 48 and a["arrivals"] >= 256
    assert a["lost"] > 0 and a["lost"] == a["retries"] + a["permanent_lost"]
    assert [kind for _t, kind, _z in a["chaos_log"]] == ["kill_zone",
                                                         "heal_zone"]
    assert b["records"] == b["arrivals"] == 4 * 64
