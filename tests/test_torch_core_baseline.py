"""The port's copy of the vanilla-OpenWhisk baseline (``core/baseline.py``)
against the reference, and the port's ``repro_torch.core`` surface against
``repro.core``'s, so that a module left out of the copy shows here."""
import random

import pytest

import repro.core as ref_core
import repro_torch.core as port_core
from repro_torch.core import (ClusterState, Registry, SchedulingFailure,
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
