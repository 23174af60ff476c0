"""The port's forecast plug-in (``repro_torch.forecast``) against the JAX
package's, on the CPU.

Each test of ``tests/test_forecast.py`` runs here on both packages with the
same inputs: the estimators, the planner's Listing-1 validity, budget,
migration and retirement, the predictive keep-alive policy, the pool's
prewarm / migrate entry points, the predictive simulator runs and the
engine's forecast feed.  The port must meet the reference test's own
expectations and give the reference's values exactly: rates, crossing
times, seasonal factors, successor edges, planner actions, pool metrics,
and, where a test drives the simulator, the records, rng draws, pool
metrics and planner stats of the port's ``device="cpu"`` Platform against
the reference's ``backend="ref"`` one.  Then ``benchmarks/coldstart.py``'s
predictive column on the paper testbed, and ``chip_smoke.py``'s phase 13
at a reduced cluster.
"""
import dataclasses
import math
import os
import random
import types
import warnings

import pytest

torch = pytest.importorskip("torch")
# torch's intra-op threads: this pytest-xdist worker's share of the cores
torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", 1))))

import repro.cluster.simulator as ref_sim  # noqa: E402
import repro.cluster.topology as ref_topology  # noqa: E402
import repro.core as ref_core  # noqa: E402
import repro.core.scheduler as ref_scheduler  # noqa: E402
import repro.core.state as ref_state  # noqa: E402
import repro.forecast as ref_forecast  # noqa: E402
import repro.platform as ref_platform  # noqa: E402
import repro.pool as ref_pool  # noqa: E402
import repro.serve.engine as ref_engine  # noqa: E402
import repro.workload as ref_workload  # noqa: E402
import repro_torch.cluster.simulator as port_sim  # noqa: E402
import repro_torch.cluster.topology as port_topology  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
import repro_torch.core.scheduler as port_scheduler  # noqa: E402
import repro_torch.core.state as port_state  # noqa: E402
import repro_torch.forecast as port_forecast  # noqa: E402
import repro_torch.platform as port_platform  # noqa: E402
import repro_torch.pool as port_pool  # noqa: E402
import repro_torch.serve.engine as port_engine  # noqa: E402
import repro_torch.workload as port_workload  # noqa: E402

import chip_smoke  # noqa: E402


def _side(sim, topology, core, scheduler, state, forecast, platform, pool,
          engine, workload, engine_kw, **platform_kw):
    """One package's names in one namespace, with the keywords that pick
    its decision route: the reference's ``backend="ref"`` (float32 jnp), the
    port's ``device="cpu"`` (the kernels' plain versions)."""
    ns = types.SimpleNamespace(platform_kw=platform_kw, engine_kw=engine_kw)
    for mod in (sim, topology, core, scheduler, state, forecast, platform,
                pool, engine, workload):
        for name in dir(mod):
            if not name.startswith("_"):
                setattr(ns, name, getattr(mod, name))
    return ns


REF = _side(ref_sim, ref_topology, ref_core, ref_scheduler, ref_state,
            ref_forecast, ref_platform, ref_pool, ref_engine, ref_workload,
            {}, backend="ref")
PORT = _side(port_sim, port_topology, port_core, port_scheduler, port_state,
             port_forecast, port_platform, port_pool, port_engine,
             port_workload, {"device": "cpu"}, device="cpu")


def test_the_port_exports_the_references_names():
    assert port_forecast.__all__ == ref_forecast.__all__
    for name in ref_forecast.__all__:
        assert getattr(port_forecast, name).__module__.startswith(
            "repro_torch.forecast.")
    assert dataclasses.asdict(port_forecast.PlanConfig()) == \
        dataclasses.asdict(ref_forecast.PlanConfig())


AFFINE_SCRIPT = """
d:
  workers: *
  strategy: random
i:
  workers: *
  strategy: random
  affinity: [d]
"""


def _pool(m, policy, **kw):
    kw.setdefault("costs", m.StartCosts(cold=0.5, warm=0.1, hot=0.0))
    return m.WarmPool(policy, **kw)


def both(fn):
    """``fn`` on the reference and on the port; the port's result, after
    asserting it equals the reference's."""
    want, got = fn(REF), fn(PORT)
    assert got == want
    return got


def actions_of(actions):
    return [(type(a).__name__, dataclasses.asdict(a)) for a in actions]


# --------------------------------------------------------------------------- #
# estimators
# --------------------------------------------------------------------------- #


def test_ewma_rate_converges_and_decays():
    def run(m):
        fc = m.ArrivalForecast(tau=10.0)
        t = 0.0
        while t < 100.0:  # steady 2/s stream
            fc.observe("f", t)
            t += 0.5
        return fc.rate("f", 100.0), fc.rate("f", 110.0), fc.rate("unseen",
                                                                 50.0)

    r100, r110, unseen = both(run)
    assert r100 == pytest.approx(2.0, rel=0.15)
    assert r110 == pytest.approx(r100 * math.exp(-1.0), rel=1e-6)
    assert unseen == 0.0


def test_keep_until_is_a_firm_strict_crossing():
    def run(m):
        fc = m.ArrivalForecast(tau=10.0)
        for k in range(20):
            fc.observe("f", k * 0.2)
        t_star = fc.keep_until("f", 4.0, horizon=5.0, threshold=0.5)
        return (t_star, fc.expected_arrivals("f", t_star, 5.0),
                fc.expected_arrivals("f", t_star - 0.01, 5.0),
                fc.keep_until("f", 4.0, 5.0, 1e9))

    t_star, at, before, below = both(run)
    assert 4.0 < t_star < float("inf")
    assert at < 0.5 and before >= 0.5
    assert below == 4.0


def test_seasonal_profile_tracks_the_cycle():
    def run(m):
        sp = m.SeasonalProfile(period=40.0, nbins=8)
        rng = random.Random(0)
        for p in range(10):
            for t in sorted(rng.random() * 20.0 for _ in range(40)):
                sp.observe(p * 40.0 + t)
            sp.observe(p * 40.0 + 39.9, weight=0.0)
        return sp.factor(405.0), sp.factor(430.0)

    on, off = both(run)
    assert on > 1.2 and off < 0.5


def test_successor_learning_and_affinity_seeding():
    def run(m):
        fc = m.ArrivalForecast()
        reg = m.Registry()
        reg.register("divide", memory=1.0, tag="d")
        reg.register("impera", memory=1.0, tag="i")
        fc.seed_affinity(m.parse(AFFINE_SCRIPT), reg)
        seeded = [dataclasses.asdict(s) for s in fc.dag.successors("divide")]
        for _ in range(10):
            fc.observe_edge("divide", "impera", 2, 0.4)
        learned = dataclasses.asdict(fc.dag.successors("divide")[0])
        return seeded, learned, fc.successor_demand({"divide": 3},
                                                    horizon=5.0)

    seeded, learned, demand = both(run)
    assert [s["child"] for s in seeded] == ["impera"]
    assert seeded[0]["count"] == pytest.approx(1.0)
    assert learned["count"] == pytest.approx(2.0, abs=0.2)
    assert learned["lag"] == pytest.approx(0.4, abs=0.05)
    assert demand["impera"] == pytest.approx(3 * learned["count"])


# --------------------------------------------------------------------------- #
# planner: Listing-1 validity, budget feasibility, migration, retirement
# --------------------------------------------------------------------------- #


def _affine_world(m):
    reg = m.Registry()
    reg.register("divide", memory=100.0, tag="d")
    reg.register("impera", memory=100.0, tag="i")
    state = m.ClusterState()
    state.add_worker("w1", max_memory=1000.0)
    state.add_worker("w2", max_memory=1000.0)
    state.allocate("divide", "w1", reg)
    return reg, state


def _assert_actions_valid(m, actions, script, reg, conf):
    """Every prewarm and migration target passes the package's own scalar
    Listing-1 ``valid``."""
    for a in actions:
        if isinstance(a, m.Prewarm):
            target = a.worker
        elif isinstance(a, m.Migrate):
            target = a.dst
        else:
            continue
        blocks = m.candidate_blocks(reg[a.function].tag, script)
        assert any(m.valid(a.function, target, conf, reg, b)
                   for b in blocks), (a.function, target)


def _hot_impera(m, n=30):
    fc = m.ArrivalForecast(tau=10.0)
    for k in range(n):
        fc.observe("impera", k * 0.1)
    return fc


def test_planner_prewarms_only_on_valid_workers_preferring_affinity():
    def run(m):
        reg, state = _affine_world(m)
        script = m.parse(AFFINE_SCRIPT)
        pool = _pool(m, m.make_policy("predictive", ttl=3.0),
                     budget_mb=500.0)
        planner = m.ForecastPlanner(_hot_impera(m), script, reg,
                                    m.PlanConfig())
        conf = state.conf()
        actions = planner.plan(conf, pool, 3.0)
        _assert_actions_valid(m, actions, script, reg, conf)
        return actions_of(actions), dict(planner.stats)

    actions, stats = both(run)
    pres = [a for kind, a in actions if kind == "Prewarm"]
    assert pres and pres[0]["worker"] == "w1"
    assert stats["epochs"] == 1 and stats["prewarms"] == len(pres)


def test_planner_honours_explicit_block_worker_lists():
    script_src = """
d:
  workers: *
  strategy: random
i:
  workers: [w2]
  strategy: random
  followup: fail
"""

    def run(m):
        reg, state = _affine_world(m)
        script = m.parse(script_src)
        pool = _pool(m, m.make_policy("predictive", ttl=3.0),
                     budget_mb=500.0)
        planner = m.ForecastPlanner(_hot_impera(m), script, reg,
                                    m.PlanConfig())
        conf = state.conf()
        ranks = (planner.valid_rank("impera", "w1", conf),
                 planner.valid_rank("impera", "w2", conf))
        return ranks, actions_of(planner.plan(conf, pool, 3.0))

    ranks, actions = both(run)
    assert ranks == (-1, 0)
    pres = [a for kind, a in actions
            if kind == "Prewarm" and a["function"] == "impera"]
    assert pres and all(a["worker"] == "w2" for a in pres)


def test_planner_respects_pool_budget():
    def run(m):
        reg, state = _affine_world(m)
        pool = _pool(m, m.make_policy("predictive", ttl=3.0),
                     budget_mb={"w1": 150.0, "w2": 250.0})
        c, _, _ = pool.acquire("divide", "w1", 0.0, memory=100.0, tag="d")
        pool.release(c.cid, 0.0)
        planner = m.ForecastPlanner(_hot_impera(m), m.parse(AFFINE_SCRIPT),
                                    reg, m.PlanConfig())
        return actions_of(planner.plan(state.conf(), pool, 3.0))

    actions = both(run)
    per_worker = {"w1": 50.0, "w2": 250.0}
    for kind, a in actions:
        if kind == "Prewarm":
            per_worker[a["worker"]] -= a["memory"]
        elif kind == "Retire":
            per_worker[a["worker"]] += 100.0
    assert all(v >= 0 for v in per_worker.values()), per_worker


def test_planner_migrates_stranded_container_to_affinity_worker():
    def run(m):
        reg, state = _affine_world(m)
        script = m.parse(AFFINE_SCRIPT)
        pool = _pool(m, m.make_policy("predictive", ttl=3.0),
                     budget_mb=500.0)
        c, _, _ = pool.acquire("impera", "w2", 0.0, memory=100.0, tag="i")
        pool.release(c.cid, 0.0)
        conf = state.conf()
        actions = m.ForecastPlanner(_hot_impera(m), script, reg,
                                    m.PlanConfig()).plan(conf, pool, 3.0)
        _assert_actions_valid(m, actions, script, reg, conf)
        return actions_of(actions)

    migs = [a for kind, a in both(run) if kind == "Migrate"]
    assert migs and migs[0]["src"] == "w2" and migs[0]["dst"] == "w1"


def test_planner_retires_on_collapsed_demand():
    def run(m):
        reg, state = _affine_world(m)
        script = m.parse(AFFINE_SCRIPT)
        fc = m.ArrivalForecast(tau=10.0)
        fc.observe("impera", 0.0)
        pool = _pool(m, m.make_policy("predictive", ttl=3.0),
                     budget_mb=500.0)
        c, _, _ = pool.acquire("impera", "w2", 0.0, memory=100.0, tag="i")
        pool.release(c.cid, 0.0)
        collapsed = m.ForecastPlanner(fc, script, reg, m.PlanConfig()).plan(
            state.conf(), pool, 500.0)
        pool.pending_add(["i"])
        pending = m.ForecastPlanner(fc, script, reg, m.PlanConfig()).plan(
            state.conf(), pool, 500.0)
        return actions_of(collapsed), actions_of(pending)

    collapsed, pending = both(run)
    assert ("Retire", {"function": "impera", "worker": "w2"}) in collapsed
    assert not any(kind == "Retire" for kind, _ in pending)


# --------------------------------------------------------------------------- #
# predictive keep-alive policy
# --------------------------------------------------------------------------- #


def test_predictive_policy_retains_predicted_functions_past_ttl():
    def run(m):
        fc = m.ArrivalForecast(tau=10.0)
        for k in range(40):
            fc.observe("f", k * 0.25)
        pool = _pool(m, m.PredictiveKeepAlive(ttl=3.0, horizon=6.0).bind(fc))
        c, _, _ = pool.acquire("f", "w", 9.0, memory=1.0, tag="x")
        pool.release(c.cid, 10.0)
        kept = pool.sweep(14.0)
        nxt = pool.next_event(14.0)
        return len(kept), nxt, len(pool.sweep(nxt))

    kept, nxt, swept = both(run)
    assert kept == 0
    assert nxt is not None and 14.0 < nxt < float("inf")
    assert swept == 1


def test_predictive_policy_unbound_matches_affinity():
    def run(m):
        pools = (_pool(m, m.PredictiveKeepAlive(ttl=5.0)),
                 _pool(m, m.AffinityAwareKeepAlive(ttl=5.0)))
        for pool in pools:
            c, _, _ = pool.acquire("f", "w", 0.0, memory=1.0, tag="x")
            pool.release(c.cid, 1.0)
        return [(p.next_event(2.0), len(p.sweep(6.0))) for p in pools]

    assert both(run) == [(6.0, 1), (6.0, 1)]


# --------------------------------------------------------------------------- #
# pool entry points: prewarm / migrate
# --------------------------------------------------------------------------- #


def test_prewarm_first_use_is_a_warm_hit():
    def run(m):
        pool = _pool(m, m.make_policy("fixed_ttl", ttl=100.0),
                     hot_window=2.0)
        c = pool.prewarm("f", "w", 0.0, memory=1.0, tag="x")
        out = [c is not None, pool.metrics.prewarm_starts,
               pool.warmth("f", "w", 0.5)]
        got, kind, cost = pool.acquire("f", "w", 0.5, memory=1.0)
        out += [got.cid == c.cid, kind, cost, pool.metrics.prewarm_hits,
                pool.metrics.cold_starts]
        pool.release(got.cid, 1.0)
        return out + [pool.warmth("f", "w", 1.5)]

    assert both(run) == [True, 1, 1, True, "warm", 0.1, 1, 0, 2]


def test_prewarm_refused_over_budget_never_evicts():
    def run(m):
        pool = _pool(m, m.make_policy("fixed_ttl", ttl=100.0), budget_mb=2.0)
        c, _, _ = pool.acquire("f", "w", 0.0, memory=2.0)
        pool.release(c.cid, 1.0)
        return (pool.prewarm("g", "w", 2.0, memory=1.0), pool.idle_count("w"),
                pool.metrics.prewarm_starts, pool.metrics.prewarm_wasted)

    assert both(run) == (None, 1, 1, 1)


def test_unused_prewarm_counts_as_wasted():
    def run(m):
        pool = _pool(m, m.make_policy("fixed_ttl", ttl=5.0))
        pool.prewarm("f", "w", 0.0, memory=1.0)
        return (len(pool.sweep(5.0)), pool.metrics.prewarm_wasted,
                pool.metrics.prewarm_waste_ratio)

    assert both(run) == (1, 1, 1.0)


def test_migrate_moves_idle_container_between_workers():
    def run(m):
        pool = _pool(m, m.make_policy("fixed_ttl", ttl=100.0))
        c, _, _ = pool.acquire("f", "w1", 0.0, memory=1.0, tag="x")
        pool.release(c.cid, 1.0)
        moved = pool.migrate("f", "w1", "w2", 2.0)
        return (moved is not None and moved.cid == c.cid, moved.worker,
                pool.metrics.migrations, pool.residency_counts(),
                pool.acquire("f", "w2", 3.0, memory=1.0)[1])

    moved, worker, n, residency, kind = both(run)
    assert moved and worker == "w2" and n == 1
    assert residency == {("w2", "f"): 1} and kind != "cold"


def test_migrate_in_refused_when_destination_filled_up():
    def run(m):
        pool = _pool(m, m.make_policy("fixed_ttl", ttl=100.0), budget_mb=1.0)
        c, _, _ = pool.acquire("f", "w1", 0.0, memory=1.0)
        pool.release(c.cid, 1.0)
        mid = pool.migrate_out("f", "w1", 2.0)
        pool.acquire("g", "w2", 2.0, memory=1.0)
        return (pool.migrate_in(mid, "w2", 2.5), mid.state.value,
                pool.metrics.migrations)

    assert both(run) == (False, "dead", 0)


# --------------------------------------------------------------------------- #
# end-to-end: predictive simulator runs, each package on its own Platform
# --------------------------------------------------------------------------- #

BENCH_SCRIPT = chip_smoke.PRED_SCRIPT


def _checked_planner(m):
    class Checked(m.ForecastPlanner):
        """Re-asserts Listing-1 validity for every placement at every
        epoch."""

        def plan(self, conf, pool, now):
            actions = super().plan(conf, pool, now)
            _assert_actions_valid(m, actions, self.script, self.registry,
                                  conf)
            return actions

    return Checked


def _run_predictive(m, scenario, seed=0, duration=90.0, policy="predictive",
                    **sim_kw):
    """``tests/test_forecast.py``'s predictive run (``policy="affinity"``:
    its affinity baseline), decided by the package's Platform.  Returns the
    records, the rng tail, the pool's metrics and the planner's stats."""
    keep = m.make_policy(policy, ttl=3.0)
    pool = _pool(m, keep, budget_mb=512.0, hot_window=1.0)
    kw = dict(plan_interval=1.0) if policy == "predictive" else {}
    sim = m.ClusterSim(m.paper_testbed(), m.SimParams(), seed=seed,
                       pool=pool, **kw, **sim_kw)
    m.register_functions(sim.registry)
    plat = m.Platform.for_sim(sim, BENCH_SCRIPT, **m.platform_kw)
    fc = planner = None
    if policy == "predictive":
        fc = m.ArrivalForecast(tau=20.0)
        fc.seed_affinity(plat.script, sim.registry)
        keep.bind(fc)
        planner = sim.planner = _checked_planner(m)(
            fc, plat.compiled, sim.registry, m.PlanConfig())
    rng = random.Random(seed + 1)
    wl = m.TraceWorkload(sim, plat.placer(rng), m.COMPUTE_S,
                         script=plat.script, forecast=fc)
    wl.load(m.build_trace(scenario, duration=duration, rate=2.0, seed=seed))
    sim.run()
    return {"records": [repr(r) for r in wl.records],
            "rng_tail": [rng.random() for _ in range(4)],
            "pool": pool.metrics.snapshot(),
            "planner": None if planner is None else dict(planner.stats),
            "metrics": pool.metrics}


def _port_equals_reference(scenario, **kw):
    ref = _run_predictive(REF, scenario, **kw)
    port = _run_predictive(PORT, scenario, **kw)
    for key in ("records", "rng_tail", "pool", "planner"):
        assert port[key] == ref[key], key
    return port


def test_sim_predictive_terminates_and_validly_prewarms():
    out = _port_equals_reference("chained")
    m = out["metrics"]
    ok = [r for r in out["records"] if "failed=False" in r]
    assert m.total_starts == len(ok) and len(ok) > 0
    assert m.prewarm_starts > 0
    assert m.prewarm_seconds > 0
    assert m.prewarm_hits + m.prewarm_wasted <= m.prewarm_starts
    assert out["planner"]["prewarms"] > 0


def test_sim_predictive_beats_affinity_cold_rate_on_poisson():
    pred = _port_equals_reference("poisson")
    aff = _port_equals_reference("poisson", policy="affinity")
    assert pred["metrics"].cold_start_rate < aff["metrics"].cold_start_rate


def test_coldstart_predictive_column_equals_the_reference():
    """``benchmarks/coldstart.py``'s predictive column on the paper testbed,
    a few seconds of each scenario, with its planner's migration cost."""
    for scenario in ("poisson", "bursty", "diurnal", "chained"):
        _port_equals_reference(scenario, duration=6.0, migrate_cost=0.25)


# --------------------------------------------------------------------------- #
# engine: forecast feed + stats
# --------------------------------------------------------------------------- #


def test_engine_feeds_estimator_and_exposes_forecast_stats():
    def run(m):
        t = [0.0]

        def clock():
            return t[0]

        def runner(req, cell):
            t[0] += 0.01
            return "ok"

        with warnings.catch_warnings():  # the reference test's v1 shape
            warnings.simplefilter("ignore", DeprecationWarning)
            eng = m.Engine(m.two_pod_cells(), runner=runner, clock=clock,
                           heartbeat_timeout=1e9,
                           forecast=m.ArrivalForecast(tau=10.0),
                           **m.engine_kw)
            bare = m.Engine(m.two_pod_cells(), runner=runner, clock=clock,
                            **m.engine_kw)
        eng.deploy("m1", ["pod0-cell0", "pod0-cell1"], weights_gb=8)
        for _ in range(5):
            eng.submit(m.Request(model="m1", kind="decode"))
            t[0] += 0.2
        return eng.forecast_stats(), bare.forecast_stats()

    stats, bare = both(run)
    assert stats["decode-m1"]["rate_per_s"] > 0
    assert stats["decode-m1"]["service_s"] == pytest.approx(0.01, abs=0.005)
    assert bare == {}


# --------------------------------------------------------------------------- #
# chip_smoke.py's phase 13 at a reduced cluster
# --------------------------------------------------------------------------- #


def test_chip_smoke_predictive_path_at_a_reduced_cluster():
    """Phase 13 on the CPU at 48 testbed copies (288 workers): the
    ``device="cpu"`` run held to its own cpu and float64 twins, prewarms
    issued, every target Listing-1 valid."""
    out = chip_smoke.predictive_path(48, device="cpu")
    assert out["workers"] == 288 and out["planner"]["prewarms"] > 0
    assert out["decisions"] > out["arrivals"] and out["records"] > 0
    assert out["planner"]["epochs"] == chip_smoke.PRED_EPOCHS == 2
