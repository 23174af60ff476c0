"""The port's copy of the vanilla-OpenWhisk baseline (``core/baseline.py``)
against the reference, and the port's ``repro_torch.core`` surface against
``repro.core``'s, so that a module left out of the copy shows here."""
import os
import random

import pytest

torch = pytest.importorskip("torch")
# torch's intra-op threads: this pytest-xdist worker's share of the cores
torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", 1))))

import repro.core as ref_core  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro_torch.core import (ClusterState, Registry, SchedulingFailure,  # noqa: E402
                              schedule_vanilla, try_schedule_vanilla)


def mk(workers=("w1", "w2", "w3"), mem=100.0):
    st = ClusterState()
    for w in workers:
        st.add_worker(w, max_memory=mem)
    return st, Registry()


def test_core_exports_equal_the_reference():
    assert port_core.__all__ == ref_core.__all__
    assert schedule_vanilla.__module__ == "repro_torch.core.baseline"


def test_vanilla_baseline_respects_capacity():
    st, reg = mk(workers=("w1", "w2"), mem=10)
    reg.register("f", memory=6, tag="t")
    w = schedule_vanilla("f", st.conf(), reg)
    st.allocate("f", w, reg)
    w2 = schedule_vanilla("f", st.conf(), reg)
    assert w2 != w  # first is full
    st.allocate("f", w2, reg)
    with pytest.raises(SchedulingFailure):
        schedule_vanilla("f", st.conf(), reg)
    assert try_schedule_vanilla("f", st.conf(), reg) is None


@pytest.mark.parametrize("seed", range(4))
def test_vanilla_baseline_equals_the_reference(seed):
    """The same home-worker hash and the same step-through on a seeded
    cluster: worker for worker, until both run out of room."""
    rng = random.Random(seed)
    workers = tuple(f"w{i}" for i in range(7))
    mems = [rng.choice((4.0, 8.0, 16.0)) for _ in workers]
    clusters = []
    for core in (ref_core, port_core):
        st, reg = core.ClusterState(), core.Registry()
        for w, m in zip(workers, mems):
            st.add_worker(w, max_memory=m)
        for f, m in (("fa", 2.0), ("fb", 3.0), ("fc", 5.0)):
            reg.register(f, memory=m, tag="t")
        clusters.append((core, st, reg))
    for _ in range(40):
        f = rng.choice(("fa", "fb", "fc"))
        picks = [core.try_schedule_vanilla(f, st.conf(), reg)
                 for core, st, reg in clusters]
        assert picks[0] == picks[1]
        if picks[0] is not None:
            for _, st, reg in clusters:
                st.allocate(f, picks[0], reg)


def test_the_v1_schedule_warning_names_the_port():
    """The v1 shim's deprecation points the port's users at the port's own
    entry points (the reference's text is ``tests/test_deprecation.py``'s)."""
    import warnings

    from repro_torch.core import deprecation

    st, reg = mk()
    reg.register("f", memory=1.0, tag="t")
    deprecation.reset()
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            port_core.schedule("f", st.conf(), port_core.parse(
                "t:\n  workers: *\n"), reg)
    finally:
        deprecation.reset()
    assert [str(x.message) for x in w
            if issubclass(x.category, DeprecationWarning)] == [
        "repro_torch.core.schedule() is the v1 call shape; prefer "
        "repro_torch.core.decide() (structured Decision) or "
        "repro_torch.platform.Platform.invoke()"]


def test_the_ir_version_error_names_the_port():
    _, reg = mk()
    compiled = port_core.compile_script(
        port_core.parse("t:\n  workers: *\n"), reg)
    v = port_core.IR_VERSION
    with pytest.raises(port_core.CompileError) as e:
        port_core.require_ir(compiled, version=v + 1)
    assert [(d.code, d.message) for d in e.value.diagnostics] == [(
        "ir-version",
        f"compiled-script IR version mismatch: consumer requires v{v + 1}, "
        f"product carries v{v} (v4 added the cost/reachability analysis "
        "section — recompile the source with "
        "repro_torch.core.compile_script)")]
