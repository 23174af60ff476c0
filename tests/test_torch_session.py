"""The port's ``SchedulerSession`` against the JAX reference's session.

Every decision is compared exactly (no tolerance): per-arrival decisions
through ``try_schedule`` and waves through ``decide_wave`` (live and scratch)
on the port with ``device="cpu"`` must equal the reference session on its
float32 ``backend="ref"``, decision for decision and rng draw for rng draw.
Both sides start from the same state: the reference cluster is carried into
the port with :func:`repro_torch.convert.state_from_snapshot`.

The helpers here (script and state conversion) are shared with
``test_torch_platform.py``.
"""
import dataclasses
import os
import random

import pytest

torch = pytest.importorskip("torch")
# torch's intra-op threads: this pytest-xdist worker's share of the cores
torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", 1))))

import repro_torch.core.ast as port_ast  # noqa: E402
from repro.core import AAppScript, Affinity, Block, ClusterState, Invalidate  # noqa: E402
from repro.core import Registry, SchedulerSession, TagPolicy  # noqa: E402
from repro_torch.convert import state_from_snapshot  # noqa: E402
from repro_torch.core import SchedulerSession as PortSession  # noqa: E402
from tests.test_batched_equivalence import (  # noqa: E402
    TAGS,
    clone_state,
    random_cluster,
    random_script,
    random_warmth,
)

# --------------------------------------------------------------------------- #
# crossing over: reference objects -> the port's, as plain data
# --------------------------------------------------------------------------- #


def to_port_script(script):
    """A reference AST (``repro.core.ast``) rebuilt field for field from the
    port's own AST classes."""
    def conv(x):
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            cls = getattr(port_ast, type(x).__name__)
            return cls(**{f.name: conv(getattr(x, f.name))
                          for f in dataclasses.fields(x) if f.init})
        if isinstance(x, tuple):
            return tuple(conv(v) for v in x)
        return x
    return conv(script)


def snapshot(state, reg):
    """The plain-data snapshot ``state_from_snapshot`` takes.  The reference
    lists neither its dead workers nor its id counter publicly, so both are
    read from its private fields here."""
    alive = set(state.workers())
    workers = [(w, state._max_memory[w], state.zone_of(w), w in alive)
               for w in state._alive]
    acts = sorted(state.active_activations(),
                  key=lambda a: int(a.activation_id.split("-")[1]))
    activations = [(a.activation_id, a.function, a.worker) for a in acts]
    registry = {f: (reg[f].memory, reg[f].tag) for f in reg.names()}
    next_id = int(repr(state._ids).removeprefix("count(").removesuffix(")"))
    return workers, activations, registry, next_id


def to_port_state(state, reg):
    return state_from_snapshot(*snapshot(state, reg))


def test_snapshot_replay_keeps_worker_order_and_activation_ids():
    state = ClusterState()
    reg = Registry()
    for w, m, z in (("b", 8.0, "eu"), ("a", 16.0, "us"), ("c", 4.0, "eu")):
        state.add_worker(w, max_memory=m, zone=z)
    reg.register("f", memory=1.0, tag="t")
    reg.register("g", memory=2.0, tag="u")
    acts = [state.allocate(f, w, reg) for f, w in
            (("f", "a"), ("g", "b"), ("f", "a"), ("g", "c"))]
    state.complete(acts[1].activation_id)  # a retired id mid-sequence
    port_state, port_reg = to_port_state(state, reg)
    assert tuple(port_state.conf()) == tuple(state.conf())
    assert port_state.conf() == {w: port_view(v)
                                 for w, v in state.conf().items()}
    assert [a.activation_id for a in port_state.active_activations()] == \
        [a.activation_id for a in state.active_activations()]
    assert port_reg["g"].memory == 2.0 and port_reg["g"].tag == "u"
    # ids continue after the last replayed one, like the source
    assert port_state.allocate("f", "c", port_reg).activation_id == \
        state.allocate("f", "c", reg).activation_id


def _small_cluster():
    state = ClusterState()
    reg = Registry()
    for w, m, z in (("b", 8.0, "eu"), ("a", 16.0, None), ("c", 4.0, "eu")):
        state.add_worker(w, max_memory=m, zone=z)
    reg.register("f", memory=1.0, tag="t")
    reg.register("g", memory=2.0, tag="u")
    acts = [state.allocate(f, w, reg) for f, w in
            (("f", "a"), ("g", "b"), ("f", "c"), ("g", "a"))]
    return state, reg, acts


@pytest.mark.parametrize("completed", [(3,), (2, 3), (0, 1, 2, 3)],
                         ids=["newest", "two_newest", "all"])
def test_snapshot_replay_continues_ids_after_completed_newest(completed):
    """The newest activations have completed at the source: the port's next
    id is still the source's next, not the last live one plus one."""
    state, reg, acts = _small_cluster()
    for i in completed:
        state.complete(acts[i].activation_id)
    port_state, port_reg = to_port_state(state, reg)
    assert [a.activation_id for a in port_state.active_activations()] == \
        [a.activation_id for a in state.active_activations()]
    for f, w in (("f", "b"), ("g", "c")):
        assert port_state.allocate(f, w, port_reg).activation_id == \
            state.allocate(f, w, reg).activation_id


def test_snapshot_replay_keeps_dead_worker_slot():
    """A dead worker is replayed dead: the live workers, their conf and the
    ids match the source, and a re-join lands in the source's slot."""
    state, reg, _ = _small_cluster()
    state.fail_worker("a")  # takes acts 0 and 3 with it
    port_state, port_reg = to_port_state(state, reg)
    assert port_state.workers() == state.workers() == ("b", "c")
    assert port_state.conf() == {w: port_view(v)
                                 for w, v in state.conf().items()}
    assert [a.activation_id for a in port_state.active_activations()] == \
        [a.activation_id for a in state.active_activations()]
    state.add_worker("a", max_memory=16.0)
    port_state.add_worker("a", max_memory=16.0)
    assert tuple(port_state.conf()) == tuple(state.conf()) == ("b", "a", "c")
    assert port_state.allocate("g", "a", port_reg).activation_id == \
        state.allocate("g", "a", reg).activation_id


def test_snapshot_replay_next_id_default_and_check():
    """Without ``next_id`` new ids follow the last replayed one; a
    ``next_id`` at or below it is refused."""
    workers = [("w0", 8.0, None, True)]
    acts = [("act-2", "f", "w0"), ("act-5", "f", "w0")]
    registry = {"f": (1.0, "t")}
    state, reg = state_from_snapshot(workers, acts, registry)
    assert state.allocate("f", "w0", reg).activation_id == "act-6"
    state, reg = state_from_snapshot(workers, acts, registry, next_id=9)
    assert state.allocate("f", "w0", reg).activation_id == "act-9"
    with pytest.raises(ValueError, match="next_id"):
        state_from_snapshot(workers, acts, registry, next_id=5)


def port_view(view):
    from repro_torch.core.state import WorkerView
    return WorkerView(**dataclasses.asdict(view))


# --------------------------------------------------------------------------- #
# per-arrival decisions
# --------------------------------------------------------------------------- #


def _sessions(state, reg, script):
    ref = SchedulerSession(state, reg, script, backend="ref")
    port_state, port_reg = to_port_state(state, reg)
    port = PortSession(port_state, port_reg, to_port_script(script),
                       device="cpu")
    return ref, port


@pytest.mark.parametrize("with_warmth", [False, True])
def test_per_arrival_decisions_equal_reference_ref(with_warmth):
    for seed in range(40):
        rng = random.Random(seed)
        script = random_script(rng)
        state, reg = random_cluster(rng)
        fs = [f"fn_{rng.choice(TAGS)}" for _ in range(rng.randint(1, 12))]
        warmth = random_warmth(rng) if with_warmth else None
        ref, port = _sessions(state, reg, script)
        rng_a, rng_b = random.Random(seed * 7 + 1), random.Random(seed * 7 + 1)
        for f in fs:
            wa = ref.try_schedule(f, rng=rng_a, warmth=warmth)
            wb = port.try_schedule(f, rng=rng_b, warmth=warmth)
            assert wa == wb, f"seed={seed} f={f}"
            if wa is not None:
                ida = ref.state.allocate(f, wa, ref.reg).activation_id
                idb = port.state.allocate(f, wb, port.reg).activation_id
                assert ida == idb
        assert rng_a.random() == rng_b.random(), f"seed={seed}: rng draws"


# --------------------------------------------------------------------------- #
# decide_wave (live and scratch)
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("with_warmth", [False, True])
@pytest.mark.parametrize("live", [False, True])
def test_decide_wave_equals_reference_ref(with_warmth, live):
    for seed in range(40):
        rng = random.Random(seed)
        script = random_script(rng)
        state, reg = random_cluster(rng)
        fs = [f"fn_{rng.choice(TAGS)}" for _ in range(rng.randint(1, 12))]
        warmth = random_warmth(rng) if with_warmth else None
        ref, port = _sessions(state, reg, script)
        rng_a, rng_b = random.Random(seed * 7 + 1), random.Random(seed * 7 + 1)
        ra = ref.decide_wave(fs, rng=rng_a, warmth=warmth,
                             apply_to=ref.state if live else None)
        rb = port.decide_wave(fs, rng=rng_b, warmth=warmth,
                              apply_to=port.state if live else None)
        assert ra.assignments == rb.assignments, f"seed={seed}"
        assert rng_a.random() == rng_b.random(), f"seed={seed}: rng draws"
        assert sorted((a.activation_id, a.function, a.worker)
                      for a in ref.state.active_activations()) == \
            sorted((a.activation_id, a.function, a.worker)
                   for a in port.state.active_activations())


def _scripted_wave_case(script, state, reg, fs, expected):
    """Both sessions, scratch and live, reproduce ``expected``."""
    for live in (False, True):
        st = clone_state(state, reg)
        ref, port = _sessions(st, reg, script)
        ra = ref.decide_wave(fs, rng=random.Random(1),
                             apply_to=ref.state if live else None)
        rb = port.decide_wave(fs, rng=random.Random(1),
                              apply_to=port.state if live else None)
        assert ra.assignments == expected, f"reference live={live}"
        assert rb.assignments == expected, f"port live={live}"


def test_wave_contends_for_last_memory_slot():
    state, reg = ClusterState(), Registry()
    for w in ("w0", "w1"):
        state.add_worker(w, max_memory=10.0)
    reg.register("fn_a", memory=6.0, tag="a")
    script = AAppScript(policies=(
        TagPolicy(tag="a", blocks=(Block(workers=("*",)),)),))
    _scripted_wave_case(script, state, reg, ["fn_a"] * 3, ["w0", "w1", None])


def test_wave_contends_for_concurrency_tokens():
    state, reg = ClusterState(), Registry()
    for w in ("w0", "w1"):
        state.add_worker(w, max_memory=100.0)
    reg.register("fn_a", memory=1.0, tag="a")
    script = AAppScript(policies=(
        TagPolicy(tag="a", blocks=(Block(
            workers=("*",),
            invalidate=Invalidate(max_concurrent_invocations=1)),),
            followup="fail"),))
    _scripted_wave_case(script, state, reg, ["fn_a"] * 3, ["w0", "w1", None])


def test_wave_affine_placement_attracts_followers():
    state, reg = ClusterState(), Registry()
    for w in ("w0", "w1", "w2"):
        state.add_worker(w, max_memory=100.0)
    reg.register("fn_a", memory=1.0, tag="a")
    reg.register("fn_b", memory=1.0, tag="b")
    script = AAppScript(policies=(
        TagPolicy(tag="a", blocks=(Block(workers=("*",)),)),
        TagPolicy(tag="b", blocks=(Block(
            workers=("*",), affinity=Affinity(affine=("a",))),),
            followup="fail"),
    ))
    _scripted_wave_case(script, state, reg, ["fn_b", "fn_a", "fn_b"],
                        [None, "w0", "w0"])


def test_compact_mid_wave_does_not_strand_tag_rows():
    for seed in range(25):
        rng = random.Random(seed + 900)
        script = random_script(rng)
        state, reg = random_cluster(rng)
        fs = [f"fn_{rng.choice(TAGS)}" for _ in range(8)]
        ref, port = _sessions(state, reg, script)
        got = {}
        for name, sess in (("ref", ref), ("port", port)):
            out = []

            def commit(i, f, w, sess=sess, out=out):
                out.append(w)
                if w is not None:
                    sess.state.allocate(f, w, sess.reg)
                if i == 3:
                    sess.compact()  # mid-wave: rebuilds the tag universe

            res = sess.decide_wave(fs, rng=random.Random(seed * 7 + 1),
                                   apply_to=sess.state, commit=commit)
            assert res.assignments == out
            got[name] = out
        assert got["port"] == got["ref"], f"seed={seed}"


def test_np_backend_is_the_float64_twin():
    """``backend="np"`` needs no device and equals the reference's np
    session."""
    for seed in range(15):
        rng = random.Random(seed)
        script = random_script(rng)
        state, reg = random_cluster(rng)
        fs = [f"fn_{rng.choice(TAGS)}" for _ in range(10)]
        ref = SchedulerSession(state, reg, script, backend="np")
        port_state, port_reg = to_port_state(state, reg)
        port = PortSession(port_state, port_reg, to_port_script(script),
                           backend="np")
        ra = ref.decide_wave(fs, rng=random.Random(seed))
        rb = port.decide_wave(fs, rng=random.Random(seed))
        assert ra.assignments == rb.assignments, f"seed={seed}"
