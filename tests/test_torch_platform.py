"""The port's ``Platform`` against the JAX reference's ``Platform``.

Both platforms start from the same cluster — the reference state carried
into the port with ``state_from_snapshot`` — and must agree exactly (no
tolerance): ``invoke``/``complete`` loops and ``decide_batch`` waves
(``apply=True`` and ``apply=False``) equal the reference on its float32
``backend="ref"``, decision for decision and rng draw for rng draw, and the
float64 ``backend="np"`` where memories lie on the 0.25 grid and no
``min_cost`` rational tie can split the two.  The port runs with
``device="cpu"``: its kernels' plain PyTorch versions.
"""
import os
import random

import pytest

torch = pytest.importorskip("torch")
# torch's intra-op threads: this pytest-xdist worker's share of the cores
torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", 1))))

from benchmarks.scheduler_scale import SCRIPT_TMPL  # noqa: E402
from repro.core import ClusterState, Registry, parse  # noqa: E402
from repro.platform import Platform as RefPlatform  # noqa: E402
from repro.pool import StartCosts, WarmPool, make_policy  # noqa: E402
from repro_torch.platform import Platform  # noqa: E402
from tests.test_bulk_wave import BATCH_FNS, BATCH_SCRIPT, ZONED_SCRIPT  # noqa: E402
from tests.test_torch_session import to_port_script, to_port_state  # noqa: E402

import chip_smoke  # noqa: E402


def _pool():
    """A reference warm pool: the port takes any object with the pool's
    duck type (each platform gets its own)."""
    return WarmPool(make_policy("fixed_ttl", ttl=1e9),
                    costs=StartCosts(cold=0.5, warm=0.1, hot=0.0),
                    budget_mb=128.0, hot_window=1e9)


def _cluster(seed, W=6, occupy=5):
    """A pre-occupied reference cluster (0.25-grid memories)."""
    state, reg = ClusterState(), Registry()
    for i in range(W):
        state.add_worker(f"w{i}", max_memory=24.0)
    for f, (mem, tag) in BATCH_FNS.items():
        reg.register(f, memory=mem, tag=tag)
    rng = random.Random(seed)
    for _ in range(occupy):
        f = rng.choice(sorted(BATCH_FNS))
        w = f"w{rng.randrange(W)}"
        view = state.conf()[w]
        if view.memory_used + reg[f].memory <= view.max_memory:
            state.allocate(f, w, reg)
    return state, reg


def _pair(seed, script=BATCH_SCRIPT, ref_backend="ref", pool=True):
    state, reg = _cluster(seed)
    port_state, port_reg = to_port_state(state, reg)
    ref = RefPlatform(script, cluster=state, registry=reg,
                      pool=_pool() if pool else None, seed=seed,
                      backend=ref_backend)
    port = Platform(script, cluster=port_state, registry=port_reg,
                    pool=_pool() if pool else None, seed=seed, device="cpu")
    return ref, port


def _key(d):
    return (d.function, d.tag, d.worker, d.activation_id, d.start_kind,
            d.start_cost)


def _drive_invoke_complete(plat, seed):
    """An invoke loop with completions interleaved from a seeded mix."""
    mix = random.Random(seed)
    out, live = [], []
    for _ in range(30):
        if live and mix.random() < 0.3:
            plat.complete(live.pop(mix.randrange(len(live))))
            continue
        d = plat.invoke(mix.choice(sorted(BATCH_FNS)))
        out.append(_key(d))
        if d.activation_id is not None:
            live.append(d)
    return out, plat.rng.random()


@pytest.mark.parametrize("ref_backend", ["ref", "np"])
def test_invoke_complete_loop_equals_reference(ref_backend):
    """Equal to the float32 ``ref`` reference on every seed; to the float64
    ``np`` reference on the 0.25 grid (the min_cost rows here never meet a
    rational tie float64 rounding would split)."""
    for seed in range(8):
        ref, port = _pair(seed, ref_backend=ref_backend)
        assert _drive_invoke_complete(port, seed) == \
            _drive_invoke_complete(ref, seed), f"seed={seed}"
        ref.close()
        port.close()


@pytest.mark.parametrize("apply", [True, False])
@pytest.mark.parametrize("ref_backend", ["ref", "np"])
def test_decide_batch_equals_reference(apply, ref_backend):
    for seed, parts in [(0, [20]), (1, [1] * 20), (2, [5, 1, 7, 3, 4]),
                        (3, [2, 8, 10]), (4, [19, 1])]:
        ref, port = _pair(seed, ref_backend=ref_backend)
        mix = random.Random(seed)
        fs = [mix.choice(sorted(BATCH_FNS)) for _ in range(20)]
        got = {}
        for name, plat in (("ref", ref), ("port", port)):
            rng = random.Random(seed + 1)
            out, i = [], 0
            for p in parts:
                out += [_key(d) for d in plat.decide_batch(
                    fs[i:i + p], rng, apply=apply)]
                i += p
            got[name] = (out, rng.random(), sorted(
                (a.activation_id, a.function, a.worker)
                for a in plat.state.active_activations()))
        assert got["port"] == got["ref"], f"seed={seed} parts={parts}"
        ref.close()
        port.close()


def _zoned_pair(shard_floor):
    state = ClusterState()
    zones = {}
    for i in range(8):
        w = f"w{i}"
        state.add_worker(w, max_memory=24.0, zone="eu" if i < 4 else "us")
        zones[w] = "eu" if i < 4 else "us"
    reg = Registry()
    reg.register("f_api", memory=2.0, tag="api")
    port_state, port_reg = to_port_state(state, reg)
    ref = RefPlatform(ZONED_SCRIPT, cluster=state, registry=reg, zones=zones,
                      shard_floor=shard_floor, seed=1, backend="ref")
    port = Platform(ZONED_SCRIPT, cluster=port_state, registry=port_reg,
                    zones=zones, shard_floor=shard_floor, seed=1,
                    device="cpu")
    return ref, port


def test_shard_floor_delegation_is_bit_identical():
    """A zone-free script decides identically on the flat session and the
    sharded plane (invoke loop and decide_batch waves), on the port as on
    the reference."""
    runs = {}
    for floor in (1024, 4):
        ref, port = _zoned_pair(floor)
        assert port._sharded == ref._sharded == (floor == 4)
        for name, plat in (("ref", ref), ("port", port)):
            r = random.Random(2)
            inv = [_key(plat.invoke("f_api", r)) for _ in range(10)]
            wave = [d.worker for d in plat.decide_batch(
                ["f_api"] * 10, random.Random(9))]
            runs[(name, floor)] = (inv, wave)
        ref.close()
        port.close()
    assert runs[("port", 4)] == runs[("port", 1024)] == \
        runs[("ref", 4)] == runs[("ref", 1024)]


def test_smoke_script_equals_parsed_template_on_both_sides():
    """chip_smoke builds the rig's script from the port's AST classes; it
    must be the script the reference parses from ``SCRIPT_TMPL``, and the
    one the port's own parser reads."""
    from repro_torch.core import parse as port_parse

    built = chip_smoke.smoke_script()
    assert built == to_port_script(parse(SCRIPT_TMPL))
    assert built == port_parse(SCRIPT_TMPL)


def test_smoke_main_path_equals_np_twin_on_cpu():
    """chip_smoke's main path at a reduced cluster on the CPU: the float32
    path (plain versions) and the float64 twin decide identically."""
    small = 1024
    got, _ = chip_smoke.drive_main_path(
        chip_smoke.build_rig(small, device="cpu"))
    want, _ = chip_smoke.drive_main_path(
        chip_smoke.build_rig(small, backend="np"))
    assert got == want
    assert sum(w is not None for w in got["arrivals"]) > 0


def test_obs_and_resilience_bundles_are_not_ported_yet():
    """The name is kept from when the port refused both bundles.  Now both
    attach, and a hot-swap that upgrades a zoned flat platform to the
    sharded plane re-attaches obs to the new session (route spans, the
    ``zone`` collector) as the reference's ``reload_script`` does, with the
    reference's decision log byte for byte.  (The roofline oracle, once
    refused here too, is held to the reference's in
    ``test_torch_roofline.py``.)"""
    from repro.obs import Obs as RefObs
    from repro.resilience import Resilience as RefResilience
    from repro_torch.obs import Obs
    from repro_torch.resilience import Resilience

    routed = ZONED_SCRIPT.replace("strategy: best_first",
                                  "strategy: best_first\n  topology: "
                                  "local_first")

    def run(cls, obs, res, **kw):
        cluster = {f"w{i}": 24.0 for i in range(6)}
        zones = {f"w{i}": ("eu", "us")[i % 2] for i in range(6)}
        plat = cls(ZONED_SCRIPT, cluster=cluster, zones=zones,
                   functions={"f_api": (2.0, "api")}, seed=1, obs=obs,
                   resilience=res, **kw)
        assert not plat._sharded and plat.obs is obs
        assert plat.resilience is res and plat._res is res
        rng = random.Random(5)
        out = [plat.invoke("f_api", rng, zone="eu").worker for _ in range(3)]
        plat.reload_script(routed)
        assert plat._sharded and plat.session._tracer is obs.tracer
        out += [plat.invoke("f_api", rng, zone=z).worker
                for z in ("us", "eu", "us")]
        # the port's own span ring (``repro_torch.obs.spans``) aside
        return out, obs.tracer.to_jsonl(), sorted(
            k for k in obs.snapshot() if not k.startswith("spans."))

    obs = Obs.enabled()
    got = run(Platform, obs, Resilience.enabled(), device="cpu")
    want = run(RefPlatform, RefObs.enabled(), RefResilience.enabled(),
               backend="ref")
    assert got == want
    assert "route" in {r["kind"] for r in obs.tracer.records()}
    assert any(k.startswith("zone.") for k in got[2])
    assert any(k.startswith("resilience.") for k in got[2])

