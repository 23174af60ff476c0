"""Carry a cluster's scheduling state into the port.

The port shares no objects with the JAX package, so a running cluster
crosses over as plain data — a snapshot any caller can take from its own
tables — and is replayed into the port's :class:`ClusterState` and
:class:`Registry`.  Replaying in order reproduces the worker order (the
order ``conf()`` lists workers, which decides ``best_first`` ties) and the
activation ids of the running instances; the snapshot's ``next_id`` makes
new ids continue where the source's do.
"""
from __future__ import annotations

import itertools
from typing import Iterable, Mapping, Optional, Tuple

from .core.state import ClusterState, Registry

#: (name, max_memory, zone, alive); zone "" or None for an unzoned worker
WorkerRow = Tuple[str, float, Optional[str], bool]
#: (activation_id, function, worker), activation ids of the form "act-<n>"
ActivationRow = Tuple[str, str, str]


def _id_number(activation_id: str) -> int:
    prefix, _, n = activation_id.partition("-")
    if prefix != "act" or not n.isdigit():
        raise ValueError(f"activation id {activation_id!r} is not 'act-<n>'")
    return int(n)


def state_from_snapshot(
        workers: Iterable[WorkerRow],
        activations: Iterable[ActivationRow],
        registry: Mapping[str, Tuple[float, str]],
        next_id: Optional[int] = None,
) -> Tuple[ClusterState, Registry]:
    """Replay a snapshot into a fresh port ``(ClusterState, Registry)``.

    ``workers`` lists every worker in the source's order (dead ones too,
    ``alive=False``, so a later re-join lands in the same slot);
    ``activations`` lists the running instances in id order; ``registry``
    maps each function to ``(memory, tag)``.  Ids the source has already
    retired (completed activations) are skipped, so the replayed ids equal
    the source's.  ``next_id`` is the number of the id the source would
    issue next (``n`` of ``act-<n>``): the port's next allocation gets it,
    also when the source's newest activations have completed.  Without it,
    new ids continue after the last replayed one."""
    reg = Registry()
    for name, (memory, tag) in registry.items():
        reg.register(name, memory=float(memory), tag=tag)
    state = ClusterState()
    for name, max_memory, zone, alive in workers:
        state.add_worker(name, max_memory=float(max_memory),
                         zone=zone or None)
        if not alive:
            state.fail_worker(name)
    next_n = 0
    for activation_id, function, worker in activations:
        n = _id_number(activation_id)
        if n < next_n:
            raise ValueError(f"activations out of id order at "
                             f"{activation_id!r}")
        if n > next_n:
            _resume_ids(state, n)  # skip ids retired at the source
        act = state.allocate(function, worker, reg)
        if act.activation_id != activation_id:  # the id scheme drifted
            raise ValueError(f"replayed {act.activation_id!r} for "
                             f"{activation_id!r}")
        next_n = n + 1
    if next_id is not None:
        if next_id < next_n:
            raise ValueError(f"next_id {next_id} is not above the last "
                             f"replayed activation (act-{next_n - 1})")
        _resume_ids(state, next_id)
    return state, reg


def _resume_ids(state: ClusterState, n: int) -> None:
    """Make ``act-<n>`` the next id ``state`` issues.  ``ClusterState``
    (a verbatim copy of the reference's) has no public setter for its id
    counter, so the replay sets it here, in this one place."""
    state._ids = itertools.count(n)
