"""The port's resilience layer against the JAX reference's.

Admission, the fair queue, retry and the chaos harness are held to the
reference's verdicts on the same seeded input sequences; a disabled bundle
leaves decisions, records and rng draws bit-identical to no bundle at all,
as ``benchmarks/overload.py``'s bit-identity check asks; and an overload
trace and a zone outage driven through the port's ``TraceWorkload`` on
``device="cpu"`` give the reference's records (``repr``, so NaN latencies
of shed and lost records compare too) and ``permanent_lost``.
"""
import os
import random

import pytest

torch = pytest.importorskip("torch")
# torch's intra-op threads: this pytest-xdist worker's share of the cores
torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", 1))))

import repro.resilience as ref_res  # noqa: E402
from repro.cluster.simulator import ClusterSim as RefSim  # noqa: E402
from repro.cluster.simulator import SimParams as RefParams  # noqa: E402
from repro.cluster.topology import WorkerSpec as RefSpec  # noqa: E402
from repro.cluster.topology import multizone_testbed as ref_multizone  # noqa: E402
from repro.cluster.topology import paper_testbed as ref_testbed  # noqa: E402
from repro.obs.slo import SloEngine as RefSloEngine  # noqa: E402
from repro.platform import Platform as RefPlatform  # noqa: E402
from repro.pool import StartCosts as RefStartCosts  # noqa: E402
from repro.pool import WarmPool as RefWarmPool  # noqa: E402
from repro.pool import make_policy as ref_make_policy  # noqa: E402
from repro.workload import TraceWorkload as RefWorkload  # noqa: E402
from repro.workload import build_trace as ref_build_trace  # noqa: E402
from repro.workload import overload_trace as ref_overload_trace  # noqa: E402
from repro.workload import poisson_trace as ref_poisson_trace  # noqa: E402
from repro.workload import register_functions as ref_register  # noqa: E402
from repro.workload.replay import build_script as ref_build_script  # noqa: E402
import repro_torch.resilience as port_res  # noqa: E402
from repro_torch.cluster.simulator import ClusterSim, SimParams  # noqa: E402
from repro_torch.cluster.topology import (WorkerSpec, multizone_testbed,  # noqa: E402
                                          paper_testbed)
from repro_torch.obs.slo import SloEngine  # noqa: E402
from repro_torch.platform import Platform  # noqa: E402
from repro_torch.pool import StartCosts, WarmPool, make_policy  # noqa: E402
from repro_torch.resilience import Resilience  # noqa: E402
from repro_torch.workload import (COMPUTE_S, TraceWorkload, build_trace,  # noqa: E402
                                  overload_trace, poisson_trace,
                                  register_functions)
from repro_torch.workload.replay import build_script  # noqa: E402

# each package's modules, so one body drives either
PORT = dict(res=port_res, sim=ClusterSim, params=SimParams, spec=WorkerSpec,
            testbed=paper_testbed, multizone=multizone_testbed,
            platform=Platform, pool=WarmPool, costs=StartCosts,
            policy=make_policy, workload=TraceWorkload, slo=SloEngine,
            build_trace=build_trace, overload_trace=overload_trace,
            poisson_trace=poisson_trace, register=register_functions,
            build_script=build_script, kw={"device": "cpu"})
REF = dict(res=ref_res, sim=RefSim, params=RefParams, spec=RefSpec,
           testbed=ref_testbed, multizone=ref_multizone,
           platform=RefPlatform, pool=RefWarmPool, costs=RefStartCosts,
           policy=ref_make_policy, workload=RefWorkload, slo=RefSloEngine,
           build_trace=ref_build_trace, overload_trace=ref_overload_trace,
           poisson_trace=ref_poisson_trace, register=ref_register,
           build_script=ref_build_script, kw={"backend": "ref"})

COMPUTE = {"api": 0.25, "etl": 2.0}

# tests/test_resilience.py's bit-identity scripts: rng-drawing strategies
BSCRIPT = """
d:
  workers: *
  strategy: random
i:
  workers: *
  strategy: random
  affinity: [d]
"""

RSCRIPT = """
api:
  workers: *
  strategy: random
etl:
  workers: *
  strategy: random
  affinity: [api]
"""


def _pool(m):
    return m["pool"](m["policy"]("fixed_ttl", ttl=100.0),
                     costs=m["costs"](cold=0.5, warm=0.1, hot=0.0),
                     budget_mb=64.0, hot_window=100.0)


# --------------------------------------------------------------------------- #
# the parts: the same input sequence, the same verdicts
# --------------------------------------------------------------------------- #


def _admission_verdicts(m, seed):
    """A seeded stream of (tenant, function, time, queue depth) through an
    admission controller with rate limits and an SLO engine whose budget
    burns, and the controller's counters after it."""
    r = m["res"]
    slo = m["slo"]({"api": 1.0})
    adm = r.AdmissionController(
        {"gold": r.TenantPolicy(weight=2.0, rate=4.0, burst=2.0),
         "bronze": r.TenantPolicy(rate=1.0, burst=1.0)},
        default=r.TenantPolicy(rate=8.0), slo=slo, budget_floor=0.0,
        pressure_depth=3)
    rng = random.Random(seed)
    t = 0.0
    out = []
    for _ in range(300):
        t += rng.expovariate(6.0)
        fn = rng.choice(["api", "etl"])
        slo.observe("api", t, rng.choice([0.2, 3.0]))
        out.append(adm.admit(rng.choice(["gold", "bronze", "t"]), fn, t,
                             queue_depth=rng.randrange(6)))
    return out, adm.snapshot(), adm.shed, adm.admitted, slo.snapshot()


@pytest.mark.parametrize("seed", [0, 1])
def test_admission_verdicts_equal_the_reference(seed):
    got = _admission_verdicts(PORT, seed)
    assert got == _admission_verdicts(REF, seed)
    verdicts = {v for _ok, v in got[0]}
    assert {port_res.ADMIT, port_res.SHED_RATE} <= verdicts


def _fair_queue_order(m, seed):
    """Seeded pushes, pops and requeues through a weighted fair queue with
    bounded backlogs: every pop, every refused push, the counters."""
    r = m["res"]
    pols = {"gold": r.TenantPolicy(weight=3.0, queue_cap=5),
            "silver": r.TenantPolicy(weight=1.0, queue_cap=3)}
    q = r.FairQueue(lambda t: pols.get(t, r.TenantPolicy(queue_cap=2)))
    rng = random.Random(seed)
    out = []
    for i in range(400):
        op = rng.random()
        if op < 0.55:
            tenant = rng.choice(["gold", "silver", "bronze"])
            out.append(("push", tenant,
                        q.push(tenant, f"x{i}", rng.choice([0.5, 1.0, 2.0]))))
        else:
            head = q.pop()
            out.append(("pop", head))
            if head is not None and rng.random() < 0.2:
                q.requeue_front(*head)
    return out, q.depth, q.max_depth, q.dropped, q.dropped_total


@pytest.mark.parametrize("seed", [0, 1])
def test_fair_queue_order_equals_the_reference(seed):
    assert _fair_queue_order(PORT, seed) == _fair_queue_order(REF, seed)


def _retry_verdicts(m):
    r = m["res"]
    delays = [p.delay(a) for p in (r.RetryPolicy(), r.RetryPolicy(
        hedge=False, base_delay=0.1, factor=3.0, max_delay=2.0))
        for a in range(2, 12)]
    led = r.RetryLedger()
    pol = r.TenantPolicy(retry_budget=0.25)
    rng = random.Random(5)
    allowed = []
    for _ in range(200):
        tenant = rng.choice(["a", "b"])
        if rng.random() < 0.6:
            led.note_admitted(tenant)
        elif led.allowed(tenant, pol):
            led.note_retry(tenant)
            allowed.append(tenant)
        else:
            allowed.append(None)
    return delays, allowed, led.total_retries, led.retries, led.admitted


def test_retry_ladder_and_ledger_equal_the_reference():
    assert _retry_verdicts(PORT) == _retry_verdicts(REF)


def test_fault_validation_and_schedule_equal_the_reference():
    def schedule(r):
        faults = [r.Fault(2.0, r.HEAL_ZONE, "us"),
                  r.Fault(1.0, r.KILL_WORKER, "w1"),
                  r.Fault(1.0, r.KILL_ZONE, "us")]
        with pytest.raises(ValueError, match="unknown fault kind"):
            r.Fault(0.0, "reboot", "w1")
        return [(f.t, f.kind, f.target) for f in r.ChaosHarness(faults).faults]

    assert schedule(port_res) == schedule(ref_res)
    assert port_res.__all__ == ref_res.__all__


# --------------------------------------------------------------------------- #
# a disabled bundle changes nothing
# --------------------------------------------------------------------------- #


def _facade_fingerprint(m, resilience):
    plat = m["platform"].from_yaml(BSCRIPT,
                                   cluster={"w0": 8.0, "w1": 8.0, "w2": 8.0},
                                   pool=_pool(m), resilience=resilience,
                                   **m["kw"])
    plat.register("divide", memory=1.0, tag="d")
    plat.register("impera", memory=1.0, tag="i")
    rng = random.Random(7)
    mix = random.Random(11)
    out = []
    for _ in range(40):
        f = mix.choice(["divide", "impera"])
        d = plat.invoke(f, rng, tenant=mix.choice([None, "gold"]))
        out.append((f, d.worker, d.start_kind))
        if d.worker is not None:
            plat.complete(d)
    return out, [rng.random() for _ in range(3)]


def test_disabled_resilience_is_bit_identical_on_the_facade():
    bare = _facade_fingerprint(PORT, None)
    assert bare == _facade_fingerprint(PORT, Resilience())
    assert bare == _facade_fingerprint(REF, None)


def _driver_fingerprint(m, resilience):
    topo = {"wa": m["spec"]("wa", "eu", 1, 1024.0),
            "wb": m["spec"]("wb", "eu", 1, 1024.0)}
    sim = m["sim"](topo, m["params"](), seed=0)
    sim.registry.register("api", memory=128.0, tag="api")
    sim.registry.register("etl", memory=256.0, tag="etl")
    plat = m["platform"].for_sim(sim, RSCRIPT, resilience=resilience,
                                 **m["kw"])
    rng = random.Random(5)
    wl = m["workload"](sim, plat.placer(rng), COMPUTE, script=plat.script,
                       resilience=resilience)
    wl.load(m["poisson_trace"](3.0, 10.0, [("api", 2.0), ("etl", 1.0)],
                               random.Random(9)))
    sim.run()
    return [repr(r) for r in wl.records], [rng.random() for _ in range(3)]


def test_disabled_resilience_is_bit_identical_in_the_driver():
    bare = _driver_fingerprint(PORT, None)
    assert bare == _driver_fingerprint(PORT, Resilience())
    assert bare == _driver_fingerprint(REF, None)


def _overload_identity(m, attach_disabled):
    """``benchmarks/overload.py``'s bit-identity run: the poisson scenario
    on the paper testbed behind ``best_first``, a disabled bundle on both
    the facade and the driver, or none."""
    sim = m["sim"](m["testbed"](), m["params"](), seed=3)
    m["register"](sim.registry)
    res = m["res"].Resilience() if attach_disabled else None
    plat = m["platform"].for_sim(sim, m["build_script"]("best_first"),
                                 resilience=res, **m["kw"])
    rng = random.Random(7)
    wl = m["workload"](sim, plat.placer(rng), COMPUTE_S, script=plat.script,
                       resilience=res)
    wl.load(m["build_trace"]("poisson", duration=30.0, rate=2.0, seed=5))
    sim.run()
    return [repr(r) for r in wl.records], tuple(rng.random()
                                                for _ in range(4))


def test_overload_bit_identity_run_equals_the_reference():
    got = _overload_identity(PORT, True)
    assert got[0]
    assert got == _overload_identity(PORT, False)
    assert got == _overload_identity(REF, False)


# --------------------------------------------------------------------------- #
# overload and outage through the workload driver
# --------------------------------------------------------------------------- #


def _overload_run(m):
    """An overload trace of three tenants on the paper testbed: token
    buckets, SLO-aware shedding under queue pressure, bounded fair queues,
    retry; the records, the bundle's counters, the placer's rng tail."""
    r = m["res"]
    sim = m["sim"](m["testbed"](), m["params"](), seed=2)
    m["register"](sim.registry)
    obs_slo = m["slo"]({"api": 0.6, "thumb": 2.0, "etl": 4.0})
    res = r.Resilience.enabled(
        tenants={"gold": r.TenantPolicy(weight=3.0, rate=6.0, burst=4.0,
                                        queue_cap=8),
                 "free": r.TenantPolicy(rate=2.0, burst=2.0, queue_cap=4)},
        default=r.TenantPolicy(queue_cap=6), slo=obs_slo, budget_floor=0.0,
        pressure_depth=2, retry=r.RetryPolicy())
    plat = m["platform"].for_sim(sim, m["build_script"]("least_loaded"),
                                 resilience=res, **m["kw"])
    rng = random.Random(4)
    wl = m["workload"](sim, plat.placer(rng), COMPUTE_S, script=plat.script,
                       resilience=res)
    wl.load(m["overload_trace"]([("gold", 6.0), ("free", 5.0), ("t", 3.0)],
                                30.0, [("api", 6.0), ("thumb", 3.0),
                                       ("etl", 1.0)], random.Random(6)))
    sim.run()
    return ([repr(x) for x in wl.records], res.snapshot(), wl.permanent_lost,
            rng.random())


def test_overload_trace_equals_the_reference():
    got = _overload_run(PORT)
    assert got == _overload_run(REF)
    kinds = {rec.split("start_kind='")[1].split("'")[0] for rec in got[0]}
    assert "shed" in kinds and got[1]["shed"] > 0


@pytest.mark.parametrize("retry", [True, False])
def test_zone_outage_through_the_driver_equals_the_reference(retry):
    """``benchmarks/overload.py``'s outage: three zones, zone ``eu`` (where
    ``best_first`` packs the work) killed and healed by the chaos harness
    mid-trace; with retry the lost work is rescued, without it each loss
    is an honest ``lost`` record."""
    def run(m):
        r = m["res"]
        sim = m["sim"](m["multizone"](("eu", "us", "ap")), m["params"](),
                       seed=1)
        m["register"](sim.registry)
        res = r.Resilience.enabled(retry=r.RetryPolicy() if retry else None,
                                   queue=True)
        plat = m["platform"].for_sim(sim, m["build_script"]("best_first"),
                                     resilience=res, **m["kw"])
        rng = random.Random(2)
        wl = m["workload"](sim, plat.placer(rng), COMPUTE_S,
                           script=plat.script, resilience=res)
        harness = r.ChaosHarness([r.Fault(10.0, r.KILL_ZONE, "eu"),
                                  r.Fault(18.0, r.HEAL_ZONE, "eu")])
        harness.arm(wl)
        wl.load(m["build_trace"]("poisson", duration=30.0, rate=3.0, seed=4))
        sim.run()
        return ([repr(x) for x in wl.records], harness.log,
                wl.permanent_lost, res.snapshot(), rng.random())

    got = run(PORT)
    assert got == run(REF)
    assert len(got[1]) == 2
    assert (got[3]["retries"] > 0) == retry
    assert retry or got[2] > 0


def test_platform_fail_worker_loss_records_equal_the_reference():
    """The facade's structured loss records (tenant, elapsed) and the warm
    pool purge under an active bundle."""
    def run(m):
        plat = m["platform"].from_yaml(
            BSCRIPT, cluster={"w0": 8.0, "w1": 8.0}, pool=_pool(m),
            resilience=m["res"].Resilience.enabled(), **m["kw"])
        plat.register("divide", memory=1.0, tag="d")
        plat.register("impera", memory=1.0, tag="i")
        rng = random.Random(3)
        for i in range(6):
            plat.advance(0.5)
            plat.invoke(["divide", "impera"][i % 2], rng,
                        tenant=["gold", None][i % 2])
        lost = plat.fail_worker("w0")
        return ([(la.activation_id, la.function, la.tag, la.worker,
                  la.tenant, la.elapsed) for la in lost],
                plat.lost_activations, plat.pool.metrics.snapshot())

    got = run(PORT)
    assert got[0]
    assert got == run(REF)
