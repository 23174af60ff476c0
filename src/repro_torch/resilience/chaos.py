"""Chaos harness — declarative fault schedules on the simulator's clock.

A chaos run is a list of :class:`Fault` events (kill a worker, kill a
whole zone, heal either) armed as ordinary events on the
:class:`~repro_torch.cluster.simulator.ClusterSim` heap, so faults interleave
deterministically with arrivals and completions — same seed, same
carnage, bit-identical replays.

The harness fires through the *workload driver* (not the raw simulator):
``TraceWorkload.fail_worker`` is the call site that turns
``ClusterState.fail_worker``'s "returned for rescheduling" contract into
actual rescheduling (retry policy) or, at minimum, honest ``"lost"``
records instead of silent work loss.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

KILL_WORKER = "kill_worker"
KILL_ZONE = "kill_zone"
HEAL_WORKER = "heal_worker"
HEAL_ZONE = "heal_zone"

_KINDS = (KILL_WORKER, KILL_ZONE, HEAL_WORKER, HEAL_ZONE)


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injected event: at virtual time ``t``, do ``kind`` to
    ``target`` (a worker name or a zone name)."""

    t: float
    kind: str
    target: str

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"have {_KINDS}")


class ChaosHarness:
    """Arms a fault schedule onto a workload's simulator and keeps an
    execution log (``(fired_at, kind, target)``) for assertions."""

    def __init__(self, faults: Sequence[Fault]):
        self.faults: Tuple[Fault, ...] = tuple(
            sorted(faults, key=lambda f: (f.t, f.kind, f.target)))
        self.log: List[Tuple[float, str, str]] = []

    def arm(self, workload) -> None:
        """Schedule every fault on ``workload.sim``'s event heap."""
        for f in self.faults:
            workload.sim.at(f.t, lambda f=f: self._fire(workload, f))

    def _fire(self, workload, f: Fault) -> None:
        self.log.append((workload.sim.now, f.kind, f.target))
        if f.kind == KILL_WORKER:
            workload.fail_worker(f.target)
        elif f.kind == KILL_ZONE:
            workload.fail_zone(f.target)
        elif f.kind == HEAL_WORKER:
            workload.heal_worker(f.target)
        else:
            workload.heal_zone(f.target)
