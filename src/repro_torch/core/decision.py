"""Structured scheduling results — ``Decision`` and its explain-trace.

The seed API returned a bare worker string (or raised).  The v2 surface
returns a :class:`Decision`: the selected worker plus enough structure to
answer *why* — which block won, under which strategy, and (when tracing is
requested) a per-block, per-worker account of every rejection in Listing-1
order.  Traces come from the scalar reference path
(:func:`repro.core.scheduler.decide` with ``explain=True``): explain is a
debugging/observability surface, so it never needs the vectorized data plane
— but it must *agree* with it, which the bit-equality property tests pin.

Rejection reasons (the first failing Listing-1 check, in check order):

========================  ====================================================
``unknown-worker``        the block lists a worker not in ``conf`` (line 19)
``memory``                no spare memory for the function (line 19)
``invalidate:capacity``   ``capacity_used`` threshold reached (lines 22-24)
``invalidate:concurrency``  ``max_concurrent_invocations`` reached (25-27)
``affinity:<tag>``        required affine tag not resident (lines 29-31)
``anti-affinity:<tag>``   anti-affine tag resident (lines 32-34)
``warmth-tier``           valid, but dropped by warmth-tier narrowing
``zone-mask``             worker's zone fails the block's ``zone:`` terms
``zone-exhausted``        a routed zone's shard yielded no valid worker
========================  ====================================================

A valid-but-not-selected candidate carries ``reason=None`` with ``ok=True``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

REASON_UNKNOWN_WORKER = "unknown-worker"
REASON_MEMORY = "memory"
REASON_CAPACITY = "invalidate:capacity"
REASON_CONCURRENCY = "invalidate:concurrency"
REASON_WARMTH_TIER = "warmth-tier"
# zone-level reasons (aAPP v2 topology terms / the sharded router):
REASON_ZONE_MASK = "zone-mask"  # worker's zone fails the block's zone terms
REASON_ZONE_EXHAUSTED = "zone-exhausted"  # a routed zone yielded no worker


def reason_affinity(tag: str) -> str:
    return f"affinity:{tag}"


def reason_anti_affinity(tag: str) -> str:
    return f"anti-affinity:{tag}"


@dataclasses.dataclass(frozen=True)
class WorkerVerdict:
    """One (block, worker) cell of the trace.

    ``ok`` means the worker reached the strategy selection: it passed
    Listing-1 ``valid`` *and* survived warmth-tier narrowing (a valid worker
    dropped by the tier pre-pass carries ``ok=False`` with the
    ``warmth-tier`` reason).  It may still have lost the strategy's pick —
    the winning worker is the block's ``selected``."""

    worker: str
    ok: bool
    reason: Optional[str] = None  # first failing check; None when ok

    def __str__(self) -> str:  # pragma: no cover - repr sugar
        return f"{self.worker}: {'ok' if self.ok else self.reason}"


@dataclasses.dataclass(frozen=True)
class BlockTrace:
    """One evaluated block: every considered worker's verdict, in the
    reference candidate order.  Blocks after the winning one are never
    evaluated (Listing 1 stops) and therefore never appear."""

    index: int  # position in the tag's resolved candidate-block list
    strategy: str
    workers: Tuple[WorkerVerdict, ...]
    selected: Optional[str] = None  # worker this block yielded (winning block)

    @property
    def rejections(self) -> Tuple[WorkerVerdict, ...]:
        return tuple(v for v in self.workers if not v.ok)


class Decision:
    """The outcome of one scheduling decision.

    ``worker is None`` means Listing 1 line 15: no valid worker in any
    candidate block.  ``block_index``/``strategy`` identify the winning
    block when known (the explain path and the scalar reference fill them;
    the vectorized hot path may leave them unset).  ``trace`` is present
    only when explain was requested.  ``activation_id``/``start_kind``/
    ``start_cost`` are filled by :class:`repro.platform.Platform` when the
    decision was applied (allocation recorded, container start charged).

    Deliberately a hand-rolled class, not a dataclass: one ``Decision`` is
    built per :meth:`Platform.invoke`, and class-level defaults keep the
    constructor off the facade-overhead budget (``benchmarks/overhead.py``
    pins the facade tax < 5%).
    """

    # class-level defaults: the constructor only writes non-default fields
    worker: Optional[str] = None
    block_index: Optional[int] = None
    strategy: Optional[str] = None
    trace: Optional[Tuple[BlockTrace, ...]] = None
    activation_id: Optional[str] = None
    start_kind: Optional[str] = None  # cold | warm | hot | none
    start_cost: float = 0.0

    def __init__(self, function: str, tag: str,
                 worker: Optional[str] = None,
                 block_index: Optional[int] = None,
                 strategy: Optional[str] = None,
                 trace: Optional[Tuple[BlockTrace, ...]] = None,
                 activation_id: Optional[str] = None,
                 start_kind: Optional[str] = None,
                 start_cost: float = 0.0):
        self.function = function
        self.tag = tag
        if worker is not None:
            self.worker = worker
        if block_index is not None:
            self.block_index = block_index
        if strategy is not None:
            self.strategy = strategy
        if trace is not None:
            self.trace = trace
        if activation_id is not None:
            self.activation_id = activation_id
        if start_kind is not None:
            self.start_kind = start_kind
        if start_cost:
            self.start_cost = start_cost

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"Decision(function={self.function!r}, tag={self.tag!r}, "
                f"worker={self.worker!r}, block_index={self.block_index}, "
                f"strategy={self.strategy!r}, "
                f"activation_id={self.activation_id!r}, "
                f"start_kind={self.start_kind!r}, "
                f"start_cost={self.start_cost}, "
                f"traced={self.trace is not None})")

    @property
    def ok(self) -> bool:
        return self.worker is not None

    def __bool__(self) -> bool:
        return self.ok

    def rejection_reasons(self, worker: str) -> Tuple[str, ...]:
        """Every reason ``worker`` was rejected across traced blocks."""
        if self.trace is None:
            return ()
        return tuple(v.reason for bt in self.trace for v in bt.workers
                     if v.worker == worker and v.reason is not None)

    def format(self) -> str:
        """Human-readable trace rendering (Platform.explain pretty-printer)."""
        head = (f"{self.function} (tag {self.tag!r}) -> "
                f"{self.worker if self.ok else 'UNSCHEDULABLE'}")
        if self.trace is None:
            return head
        lines = [head]
        for bt in self.trace:
            sel = f" -> {bt.selected}" if bt.selected else ""
            lines.append(f"  block[{bt.index}] strategy={bt.strategy}{sel}")
            for v in bt.workers:
                lines.append(f"    {v.worker:16s} "
                             f"{'ok' if v.ok else 'rejected: ' + str(v.reason)}")
        return "\n".join(lines)
