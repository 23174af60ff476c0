"""Per-(worker, function) warm-container pools.

``WarmPool`` is the single source of truth for container residency:

* ``acquire`` answers "what does it cost to start ``f`` on ``w`` *now*" —
  hot (idle container inside the pre-pause grace window), warm (paused idle
  container: unpause) or cold (create; may first evict idle containers under
  the worker's memory budget, in the keep-alive policy's order);
* ``release`` parks the container back in the idle pool (where the janitor
  and the budget can reclaim it) — or destroys it if it was admitted
  over-budget;
* ``sweep`` is the janitor pass: retire every idle container the policy
  declares expired; ``next_event`` tells the event loop when the next expiry
  can happen so the simulator needn't poll;
* ``warmth`` ranks (function, worker) pairs 0/1/2 (cold/warm/hot) — the
  scheduler-facing view that `core.batched` consumes as its warmth-rank
  column and `serve.Engine` republishes as ``warm:<function>`` residency
  tags via the ``on_warm``/``on_cooled`` callbacks (fired on the 0↔1 idle
  transitions per (worker, function));
* ``prewarm``/``migrate`` are the forecast subsystem's entry points:
  ``prewarm`` parks a speculatively-started idle container (refused, never
  evicting, when the worker's budget has no room) whose first use is a warm
  hit; ``migrate`` (or the ``migrate_out``/``migrate_in`` pair, letting the
  simulator charge a transfer latency in between) moves an idle container
  to a worker with predicted demand; ``retire_idle`` executes a planner
  retirement.  Prewarmed containers that die unused count as
  ``prewarm_wasted``.

Pending-demand bookkeeping (``pending_add``/``pending_done`` refcounts per
tag) feeds :class:`repro_torch.pool.policy.AffinityAwareKeepAlive`.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple, Union

from .container import Container, ContainerState
from .metrics import PoolMetrics
from .policy import KeepAlivePolicy

# start kinds
COLD, WARM, HOT = "cold", "warm", "hot"

ResidencyHook = Callable[[str, str, str], None]  # (worker, function, tag)


@dataclasses.dataclass(frozen=True)
class StartCosts:
    """Latency charged per start kind, seconds.  Defaults approximate the
    OpenWhisk numbers the cold-start literature reports: ~½ s container
    create, ~⅒ s unpause, free reuse of a still-running container."""

    cold: float = 0.5
    warm: float = 0.1
    hot: float = 0.0

    def of(self, kind: str) -> float:
        return {COLD: self.cold, WARM: self.warm, HOT: self.hot}[kind]


class WarmPool:
    def __init__(
        self,
        policy: KeepAlivePolicy,
        *,
        costs: StartCosts = StartCosts(),
        budget_mb: Union[None, float, Mapping[str, float]] = None,
        hot_window: float = 2.0,
        on_warm: Optional[ResidencyHook] = None,
        on_cooled: Optional[ResidencyHook] = None,
    ):
        self.policy = policy
        self.costs = costs
        self._budget = budget_mb
        self.hot_window = float(hot_window)
        self.on_warm = on_warm
        self.on_cooled = on_cooled
        self.metrics = PoolMetrics()
        self._idle: Dict[Tuple[str, str], List[Container]] = {}
        # function -> workers holding idle containers for it (the inverted
        # index warmth_row serves from; counts mirror _idle list lengths)
        self._fn_workers: Dict[str, Dict[str, int]] = {}
        self._busy: Dict[str, Container] = {}
        self._unpooled: set = set()  # cids destroyed on release
        self._pending: Dict[str, int] = {}
        # incremental janitor index: a lazy min-heap of candidate expiries
        # (entries carry the container's park_rev; a stale rev means the
        # container left/re-entered the idle set since the push) plus a
        # parking lot for never-expiring containers (pending-affine tags),
        # re-pushed when their tag's pending demand drains.  Keeps
        # ``next_event`` O(log #idle) amortised instead of a full scan per
        # release — only usable while the policy's expiries are monotone
        # (``lazy_expiry_ok``).
        self._expiry_heap: List[Tuple[float, int, Container, int]] = []
        self._expiry_deferred: Dict[str, List[Tuple[Container, int]]] = {}
        self._expiry_seq = itertools.count()

    # ------------------------------------------------------------------ #
    # pending affinity demand
    # ------------------------------------------------------------------ #

    def pending_add(self, tags: Iterable[str]) -> None:
        for t in tags:
            self._pending[t] = self._pending.get(t, 0) + 1

    def pending_done(self, tags: Iterable[str]) -> None:
        for t in tags:
            n = self._pending.get(t, 0) - 1
            if n <= 0:
                self._pending.pop(t, None)
                self._flush_deferred(t)
            else:
                self._pending[t] = n

    def pending_tags(self) -> frozenset:
        return frozenset(self._pending)

    # ------------------------------------------------------------------ #
    # budget accounting
    # ------------------------------------------------------------------ #

    def budget_of(self, worker: str) -> Optional[float]:
        if self._budget is None:
            return None
        if isinstance(self._budget, Mapping):
            return self._budget.get(worker)
        return float(self._budget)

    def used_mb(self, worker: str) -> float:
        used = sum(c.memory for c in self._busy.values() if c.worker == worker)
        for (w, _f), lst in self._idle.items():
            if w == worker:
                used += sum(c.memory for c in lst)
        return used

    # ------------------------------------------------------------------ #
    # idle-set maintenance (residency-tag transitions live here)
    # ------------------------------------------------------------------ #

    def _park(self, c: Container, now: float) -> None:
        c.state = ContainerState.IDLE
        c.last_used = now
        c.park_rev += 1
        lst = self._idle.setdefault((c.worker, c.function), [])
        lst.append(c)
        by_fn = self._fn_workers.setdefault(c.function, {})
        by_fn[c.worker] = by_fn.get(c.worker, 0) + 1
        self._expiry_push(c, now)
        if len(lst) == 1 and self.on_warm is not None:
            self.on_warm(c.worker, c.function, c.tag)

    def _unpark(self, c: Container) -> None:
        key = (c.worker, c.function)
        lst = self._idle[key]
        lst.remove(c)
        c.park_rev += 1  # invalidates any janitor-heap / deferred entry
        by_fn = self._fn_workers.get(c.function, {})
        n = by_fn.get(c.worker, 0) - 1
        if n <= 0:
            by_fn.pop(c.worker, None)
            if not by_fn:
                self._fn_workers.pop(c.function, None)
        else:
            by_fn[c.worker] = n
        if not lst:
            del self._idle[key]
            if self.on_cooled is not None:
                self.on_cooled(c.worker, c.function, c.tag)

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #

    def acquire(self, function: str, worker: str, now: float, *,
                memory: float, tag: str = "") -> Tuple[Container, str, float]:
        """Hand out a container for one invocation.  Returns
        ``(container, kind, start_cost_seconds)``."""
        idle = self._idle.get((worker, function))
        if idle:
            c = self.policy.select(idle, now)
            kind = HOT if c.idle_for(now) <= self.hot_window else WARM
            if c.prewarmed:
                # first use of a speculative start: the runtime still injects
                # the function (an unpause-class cost), never a free hot hit
                kind = WARM
                c.prewarmed = False
                self.metrics.prewarm_hits += 1
            self._unpark(c)
            c.state = ContainerState.BUSY
            c.uses += 1
            self._busy[c.cid] = c
            cost = self.costs.of(kind)
            self.metrics.count(kind)
            self.metrics.start_seconds += cost
            return c, kind, cost

        # cold path: make room under the worker's budget first
        admitted = self._make_room(worker, memory, now)
        c = Container(function=function, tag=tag, worker=worker,
                      memory=memory, created_at=now, last_used=now)
        c.uses = 1
        self._busy[c.cid] = c
        if not admitted:
            self._unpooled.add(c.cid)
            self.metrics.unpooled_starts += 1
        cost = self.costs.of(COLD)
        self.metrics.count(COLD)
        self.metrics.start_seconds += cost
        return c, COLD, cost

    def _make_room(self, worker: str, memory: float, now: float) -> bool:
        budget = self.budget_of(worker)
        if budget is None:
            return True
        busy_used = sum(c.memory for c in self._busy.values()
                        if c.worker == worker)
        if busy_used + memory > budget:
            # even evicting every idle container cannot make this fit:
            # run unpooled instead of flushing the warm pool for nothing
            return False
        idle_here = [c for (w, _f), lst in self._idle.items() if w == worker
                     for c in lst]
        order = self.policy.evict_order(idle_here, now, self.pending_tags())
        i = 0
        while self.used_mb(worker) + memory > budget and i < len(order):
            self._retire(order[i], cause="pressure")
            i += 1
        return self.used_mb(worker) + memory <= budget

    def release(self, cid: str, now: float) -> Optional[Container]:
        """Invocation finished: park the container (or destroy if unpooled).
        Returns the container if it went idle, else None."""
        c = self._busy.pop(cid, None)
        if c is None:
            return None
        if cid in self._unpooled:
            self._unpooled.discard(cid)
            c.state = ContainerState.DEAD
            return None
        self._park(c, now)
        return c

    def destroy(self, cid: str) -> None:
        """Forcibly retire a busy container (worker failure)."""
        c = self._busy.pop(cid, None)
        if c is not None:
            self._unpooled.discard(cid)
            c.state = ContainerState.DEAD

    def _retire(self, c: Container, *, cause: str) -> None:
        self._unpark(c)
        self._mark_dead(c)
        if cause == "pressure":
            self.metrics.evictions_pressure += 1
        elif cause == "planned":
            self.metrics.evictions_planned += 1
        else:
            self.metrics.evictions_ttl += 1

    def _mark_dead(self, c: Container) -> None:
        c.state = ContainerState.DEAD
        if c.prewarmed:
            c.prewarmed = False
            self.metrics.prewarm_wasted += 1

    def evict_worker(self, worker: str) -> int:
        """Worker disappeared: retire all its idle containers.  Not counted
        as evictions in metrics, but ``on_cooled`` hooks fire — consumers
        (e.g. ``serve.Engine``) rely on them to withdraw residency tags."""
        n = 0
        for (w, _f) in [k for k in self._idle if k[0] == worker]:
            for c in list(self._idle.get((w, _f), ())):
                self._unpark(c)
                self._mark_dead(c)
                n += 1
        return n

    # ------------------------------------------------------------------ #
    # forecast-plan actions: prewarm / migrate / retire
    # ------------------------------------------------------------------ #

    def prewarm(self, function: str, worker: str, now: float, *,
                memory: float, tag: str = "") -> Optional[Container]:
        """Park a speculatively-started idle container.  Refused (returns
        ``None``) when the worker's budget has no headroom — a speculative
        start must never evict state that demand already earned.  A refusal
        still counts as a started-and-wasted prewarm: the boot happened in
        the background before the park was rejected, and hiding it would
        understate ``prewarm_waste_ratio`` exactly under memory pressure."""
        self.metrics.prewarm_starts += 1
        budget = self.budget_of(worker)
        if budget is not None and self.used_mb(worker) + memory > budget:
            self.metrics.prewarm_wasted += 1
            return None
        c = Container(function=function, tag=tag, worker=worker,
                      memory=memory, created_at=now, last_used=now,
                      prewarmed=True)
        self._park(c, now)
        return c

    def migrate_out(self, function: str, worker: str, now: float
                    ) -> Optional[Container]:
        """Detach the most expendable idle container of ``function`` from
        ``worker`` for transfer (``None`` if no idle container exists).  The
        container is in ``MIGRATING`` state until ``migrate_in`` parks it."""
        idle = self._idle.get((worker, function))
        if not idle:
            return None
        c = self.policy.evict_order(idle, now, self.pending_tags())[0]
        self._unpark(c)
        c.state = ContainerState.MIGRATING
        return c

    def migrate_in(self, c: Container, worker: str, now: float) -> bool:
        """Attach a migrating container to its destination worker.  Refused
        (the container dies, counting ``prewarm_wasted`` if it never served)
        when the destination budget filled up during the transfer."""
        budget = self.budget_of(worker)
        if budget is not None and self.used_mb(worker) + c.memory > budget:
            self._mark_dead(c)
            return False
        c.worker = worker
        self.metrics.migrations += 1
        self._park(c, now)
        return True

    def migrate(self, function: str, src: str, dst: str, now: float
                ) -> Optional[Container]:
        """Instantaneous migrate (callers that model transfer latency use the
        ``migrate_out``/``migrate_in`` pair instead)."""
        c = self.migrate_out(function, src, now)
        if c is not None and not self.migrate_in(c, dst, now):
            return None
        return c

    def retire_idle(self, function: str, worker: str, now: float
                    ) -> Optional[Container]:
        """Planner-ordered retirement: retire the most expendable idle
        container of ``function`` on ``worker`` whose tag has no pending
        affinity demand."""
        idle = self._idle.get((worker, function))
        if not idle:
            return None
        pending = self.pending_tags()
        for c in self.policy.evict_order(idle, now, pending):
            if c.tag not in pending:
                self._retire(c, cause="planned")
                return c
        return None

    # ------------------------------------------------------------------ #
    # janitor
    # ------------------------------------------------------------------ #

    def sweep(self, now: float) -> List[Container]:
        """Retire every idle container the policy declares expired."""
        pending = self.pending_tags()
        out: List[Container] = []
        for key in list(self._idle):
            for c in list(self._idle.get(key, ())):
                if self.policy.expired(c, now, pending):
                    self._retire(c, cause="ttl")
                    out.append(c)
        return out

    def _defer_expiry(self, c: Container, rev: int) -> None:
        lst = self._expiry_deferred.setdefault(c.tag, [])
        lst.append((c, rev))
        if len(lst) > 64:  # drop stale revs so a long-pending tag's list
            # stays O(#idle containers), not O(parks since it went pending)
            self._expiry_deferred[c.tag] = [
                (cc, r) for cc, r in lst
                if r == cc.park_rev and cc.state == ContainerState.IDLE]

    def _expiry_push(self, c: Container, now: float) -> None:
        pending = self.pending_tags()
        t = self.policy.next_expiry(c, now, pending)
        if t == float("inf"):
            self._defer_expiry(c, c.park_rev)
        else:
            heapq.heappush(self._expiry_heap,
                           (t, next(self._expiry_seq), c, c.park_rev))

    def _flush_deferred(self, tag: str) -> None:
        """A tag's pending demand drained: its parked never-expiring
        containers get finite expiries again — re-push the live ones."""
        for c, rev in self._expiry_deferred.pop(tag, ()):
            if rev == c.park_rev and c.state == ContainerState.IDLE:
                self._expiry_push(c, c.last_used)

    def next_event(self, now: float) -> Optional[float]:
        """Earliest future time an idle container can expire (None if the
        pool is empty or nothing can ever expire without new information).

        With a monotone-expiry policy this reads the incremental janitor
        heap — O(log #idle) amortised; stale entries (container re-parked or
        gone, or expiry pushed later by pending demand) are discarded or
        re-filed on pop.  Policies whose expiries can revise *earlier*
        (seasonal forecasts) fall back to the exact full scan."""
        if not getattr(self.policy, "lazy_expiry_ok", False):
            return self._next_event_scan(now)
        heap = self._expiry_heap
        pending = self.pending_tags()
        while heap:
            t, _, c, rev = heap[0]
            if rev != c.park_rev or c.state != ContainerState.IDLE:
                heapq.heappop(heap)
                continue
            t2 = self.policy.next_expiry(c, now, pending)
            if t2 == float("inf"):
                heapq.heappop(heap)
                self._defer_expiry(c, rev)
                continue
            if t2 > t + 1e-12:
                heapq.heappop(heap)
                heapq.heappush(heap, (t2, next(self._expiry_seq), c, rev))
                continue
            return max(t, now)
        return None

    def _next_event_scan(self, now: float) -> Optional[float]:
        pending = self.pending_tags()
        best: Optional[float] = None
        for lst in self._idle.values():
            for c in lst:
                t = self.policy.next_expiry(c, now, pending)
                if t != float("inf") and (best is None or t < best):
                    best = t
        if best is None:
            return None
        return max(best, now)

    # ------------------------------------------------------------------ #
    # scheduler-facing views
    # ------------------------------------------------------------------ #

    def has_idle(self) -> bool:
        return bool(self._idle)

    def idle_count(self, worker: Optional[str] = None) -> int:
        if worker is None:
            return sum(len(v) for v in self._idle.values())
        return sum(len(v) for (w, _f), v in self._idle.items() if w == worker)

    def residency_counts(self) -> Dict[Tuple[str, str], int]:
        """Idle-container counts per (worker, function) — the planner's
        ``residency[W, F]`` matrix source."""
        return {key: len(lst) for key, lst in self._idle.items() if lst}

    def busy_counts(self) -> Dict[str, int]:
        """In-flight invocation counts per function — the planner's supply
        term and the DAG-successor predictor's parent set."""
        out: Dict[str, int] = {}
        for c in self._busy.values():
            out[c.function] = out.get(c.function, 0) + 1
        return out

    def busy_residency_counts(self) -> Dict[Tuple[str, str], int]:
        """Busy-container counts per (worker, function): where in-flight
        containers will park when they release."""
        out: Dict[Tuple[str, str], int] = {}
        for c in self._busy.values():
            key = (c.worker, c.function)
            out[key] = out.get(key, 0) + 1
        return out

    def idle_warmth(self, now: float) -> Dict[Tuple[str, str], int]:
        """Sparse warmth table: ``(worker, function) -> rank`` for every
        non-empty idle pool — the vectorized counterpart of F x W ``warmth``
        calls.  Cost is O(#idle (worker, function) keys), i.e. proportional
        to the pool's residency table (`residency_counts`), not to the
        cluster; absent keys are rank 0 (cold)."""
        return {(w, f): self.warmth(f, w, now)
                for (w, f), lst in self._idle.items() if lst}

    def warmth_row(self, function: str, now: float) -> Dict[str, int]:
        """One function's warmth column: ``worker -> rank`` over the workers
        holding an idle container for it (others are rank 0).  The per-
        decision form of :meth:`idle_warmth` the scheduling session uses —
        O(workers actually holding ``function``) via the inverted residency
        index, independent of cluster size."""
        return {w: self.warmth(function, w, now)
                for w in self._fn_workers.get(function, ())}

    def warmth(self, function: str, worker: str, now: float) -> int:
        """0 = cold, 1 = warm, 2 = hot — the batched path's warmth rank.
        Ranks the container the keep-alive policy would actually serve, so
        the advertised tier matches what ``acquire`` will charge (a never-used
        prewarmed container serves at warm, not hot: function injection)."""
        idle = self._idle.get((worker, function))
        if not idle:
            return 0
        c = self.policy.select(idle, now)
        if c.prewarmed:
            return 1
        return 2 if c.idle_for(now) <= self.hot_window else 1
