"""Weighted-fair queueing of pending arrivals — bounded per-tenant backlogs.

Self-clocked fair queueing (SCFQ): each queued item gets a virtual *finish
tag* ``F = max(V, F_last(tenant)) + cost / weight`` where ``V`` is the
queue's virtual time (the finish tag of the item most recently served) and
``cost`` the item's expected service demand (cpu-seconds here).  Serving
always picks the globally smallest tag, so a tenant with weight 2 drains
twice as fast as a weight-1 tenant under contention, and one tenant's
burst cannot starve the others — its backlog just earns ever-later tags.

Per-tenant backlogs are **bounded** (``TenantPolicy.queue_cap``): a push
beyond the cap is refused (the caller sheds the arrival), which is the
backpressure half of ROADMAP item 5 — bounded memory under overload
instead of an unbounded pending heap.

The head scan on :meth:`pop` is O(#tenants) — tenants are few (a handful
of buckets, not a handful of requests) and the determinism of a plain scan
with a total (tag, seq) order is worth more than a lazy-heap's constant
factor.  No clocks, no randomness: bit-identical replays.
"""
from __future__ import annotations

import itertools
from collections import deque
from typing import Callable, Deque, Dict, Optional, Tuple

from .admission import TenantPolicy


class FairQueue:
    """SCFQ over per-tenant FIFO deques.  ``policy_fn`` maps tenant ->
    :class:`TenantPolicy` (share the admission controller's to keep one
    source of truth for weights and caps)."""

    def __init__(self, policy_fn: Callable[[str], TenantPolicy]):
        self._policy = policy_fn
        # tenant -> deque of (finish_tag, seq, item); FIFO per tenant
        self._q: Dict[str, Deque[Tuple[float, int, object]]] = {}
        self._last_tag: Dict[str, float] = {}
        self._vtime = 0.0
        self._seq = itertools.count()
        self.depth = 0
        self.max_depth = 0
        self.dropped: Dict[str, int] = {}  # per-tenant cap overflows

    def push(self, tenant: str, item: object, cost: float) -> bool:
        """Enqueue ``item`` for ``tenant``; ``False`` when its backlog is
        at cap (the caller records the shed)."""
        pol = self._policy(tenant)
        dq = self._q.get(tenant)
        if dq is None:
            dq = self._q[tenant] = deque()
        if len(dq) >= pol.queue_cap:
            self.dropped[tenant] = self.dropped.get(tenant, 0) + 1
            return False
        tag = max(self._vtime, self._last_tag.get(tenant, 0.0)) \
            + max(cost, 0.0) / pol.weight
        self._last_tag[tenant] = tag
        dq.append((tag, next(self._seq), item))
        self.depth += 1
        if self.depth > self.max_depth:
            self.max_depth = self.depth
        return True

    def pop(self) -> Optional[Tuple[str, float, int, object]]:
        """Dequeue the globally smallest (tag, seq); ``None`` when empty.
        Returns ``(tenant, tag, seq, item)`` — tag and seq round-trip
        through :meth:`requeue_front` when the caller cannot dispatch."""
        best = None
        best_key = None
        for tenant, dq in self._q.items():
            if not dq:
                continue
            key = (dq[0][0], dq[0][1])
            if best_key is None or key < best_key:
                best_key = key
                best = tenant
        if best is None:
            return None
        tag, seq, item = self._q[best].popleft()
        self.depth -= 1
        if tag > self._vtime:
            self._vtime = tag
        return best, tag, seq, item

    def requeue_front(self, tenant: str, tag: float, seq: int,
                      item: object) -> None:
        """Put a popped-but-undispatchable item back at its tenant's head
        with its original tag — it stays the tenant's next candidate and
        its fair-share position is preserved (no cap check: the slot it
        vacated is still free)."""
        self._q.setdefault(tenant, deque()).appendleft((tag, seq, item))
        self.depth += 1
        if self.depth > self.max_depth:
            self.max_depth = self.depth

    @property
    def dropped_total(self) -> int:
        return sum(self.dropped.values())

    def depth_of(self, tenant: str) -> int:
        dq = self._q.get(tenant)
        return len(dq) if dq is not None else 0
