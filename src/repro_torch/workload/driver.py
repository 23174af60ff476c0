"""Replay an arrival trace onto :class:`repro_torch.cluster.simulator.ClusterSim`.

``TraceWorkload`` is the open-loop counterpart of the closed-loop
divide-et-impera workload: every :class:`repro_torch.workload.traces.Arrival` is
submitted at its trace time, scheduled through the real aAPP machinery,
charged its container start (cold/warm/hot via the simulator's warm pool,
when one is attached), computed under processor sharing, and recorded.

DAG children declared on an arrival are spawned when the parent's compute
finishes — the moment a running ``divide`` invokes its ``impera``s.

Pending-demand plumbing: while an invocation is in flight the pool's pending
set holds its own tag, every tag its aAPP policy is affine to, and its
children's tags — the signal :class:`AffinityAwareKeepAlive` retains warm
containers against.

Forecast plumbing (optional): with an
:class:`repro_torch.forecast.ArrivalForecast` attached, every submission is
reported to the estimator (``observe``), every completion reports its busy
time (``observe_service``), and every DAG spawn reports the
``parent -> (child, count, lag)`` edge (``observe_edge``) — the observation
stream the predictive planner and keep-alive policy run on.

Resilience plumbing (optional): with a :class:`repro_torch.resilience.Resilience`
bundle attached, root arrivals pass per-tenant token-bucket **admission**
(SLO-aware shedding under backlog pressure), admitted work flows through a
bounded **weighted-fair queue** (queue wait is charged to the attribution's
``parent_wait`` — the window anchors at the arrival, dispatch happens when
the pump drains), and activations a killed worker was running are
**retried** under the bundle's backoff policy and per-tenant retry budget.
The chaos entry points (:meth:`fail_worker` / :meth:`fail_zone` /
:meth:`heal_worker` / :meth:`heal_zone`) are what a
:class:`repro_torch.resilience.ChaosHarness` fires; they honour the
``ClusterState.fail_worker`` contract — lost activations are *actually*
rescheduled, or failing every rescue, recorded as ``"lost"`` instead of
silently dropped.  With no bundle (or a disabled one) the submit path is
the historical code, bit-identical in decisions and rng draws.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.ast import AAppScript
from repro_torch.core.scheduler import candidate_blocks
from repro_torch.obs.attribution import LatencyAttributor, build as build_attribution
from repro_torch.resilience import DEFAULT_TENANT, LostActivation

from .traces import Arrival

_UNSET = object()  # "no pre-computed decision" sentinel (None is a decision)


@dataclasses.dataclass(frozen=True)
class InvocationRecord:
    function: str
    worker: str
    t_submit: float
    latency: float
    # cold | warm | hot | none (no pool) | failed (unschedulable) |
    # shed (refused by admission/backpressure) | lost (worker died,
    # every rescue exhausted)
    start_kind: str
    failed: bool
    origin_zone: Optional[str] = None  # the arrival's zone stamp (if any)
    # deterministic activation key for replay diffs: roots are "a<i>" in
    # trace order, DAG children "<parent>/<fn><k>" — stable across runs
    arrival_id: Optional[str] = None
    # root arrival time of the chain (== t_submit for roots); the
    # attribution window of a chained child starts here
    t_root: Optional[float] = None
    # latency attribution (repro_torch.obs.attribution.COMPONENTS); None only
    # for failed records.  Invariant: sum(components) in canonical order
    # == latency + components["parent_wait"], bit-exactly.
    components: Optional[Dict[str, float]] = None
    # the simulator activation id — joins records to tracer invoke spans
    activation_id: Optional[str] = None
    # owning tenant stamp (admission control); None = default tenant
    tenant: Optional[str] = None
    # submission attempts consumed (1 = first try; >1 = retried lost work)
    attempts: int = 1


def affine_terms_of(script: Optional[AAppScript], tag: str) -> List[str]:
    """Tags the policy for ``tag`` is affine to (across candidate blocks)."""
    if script is None:
        return []
    out: List[str] = []
    for b in candidate_blocks(tag, script):
        for t in b.affinity.affine:
            if t not in out:
                out.append(t)
    return out


class _Inflight:
    """Driver-side bookkeeping for one dispatched activation — what loss
    handling needs to rescue it (pure bookkeeping: no clocks, no rng)."""

    __slots__ = ("arrival", "arrival_id", "t_root", "attempt", "pending",
                 "t0", "worker")

    def __init__(self, arrival, arrival_id, t_root, attempt, pending,
                 t0, worker):
        self.arrival = arrival
        self.arrival_id = arrival_id
        self.t_root = t_root
        self.attempt = attempt
        self.pending = pending
        self.t0 = t0
        self.worker = worker


class TraceWorkload:
    """Drives ``sim`` from a trace.  Functions must be pre-registered in
    ``sim.registry``; ``compute`` maps function name -> single-vCPU seconds."""

    def __init__(
        self,
        sim,
        scheduler_fn: Callable[[str], Optional[str]],
        compute: Dict[str, float],
        *,
        script: Optional[AAppScript] = None,
        forecast=None,
        obs=None,
        resilience=None,
        batcher: Optional[Callable[..., Sequence[Optional[str]]]] = None,
    ):
        self.sim = sim
        self.schedule = scheduler_fn
        self.compute = dict(compute)
        self.script = script
        self.forecast = forecast
        # wave batcher (Platform.batch_placer): same-tick arrival groups
        # are decided in one fused bulk pass instead of per-arrival calls.
        # Decisions stay bit-identical to the sequential path (the batcher
        # resolves intra-wave conflicts as-if-applied), so batching is a
        # pure dispatch-cost optimisation
        self.batcher = batcher
        # decision/invoke/complete spans on the simulator's virtual clock —
        # activation ids key the spans, so timelines are deterministic.
        # A traced Platform.placer marks itself `traces_decisions`; then the
        # driver adds only invoke/complete to the shared span, instead of
        # opening a duplicate begin/decision per arrival
        self._tracer = obs.tracer if obs is not None else None
        self._place_traces = bool(
            getattr(scheduler_fn, "traces_decisions", False))
        # attribution always runs (pure arithmetic on values the driver
        # already holds — no clock reads, no rng, no event-time changes);
        # the histogram/SLO feeds only exist with an obs bundle attached
        self._attr = LatencyAttributor(obs.registry) if obs is not None \
            else None
        self._slo = obs.slo if obs is not None else None
        # resilience layer: a disabled bundle collapses to None references,
        # leaving the submit path the historical code (bit-identical)
        self.resilience = resilience \
            if (resilience is not None and resilience.active) else None
        res = self.resilience
        self._admission = res.admission if res is not None else None
        self._queue = res.queue if res is not None else None
        self._retry = res.retry if res is not None else None
        self._pumping = False
        # in-flight ledger (always on — pure dict bookkeeping, no rng/clock
        # effects): activation id -> _Inflight, consumed by loss handling
        self._inflight: Dict[str, _Inflight] = {}
        self.permanent_lost = 0  # activations no rescue could save
        self.records: List[InvocationRecord] = []

    def load(self, trace: Sequence[Arrival]) -> None:
        # group consecutive same-instant, same-zone arrivals into one bulk
        # wave when a batcher is wired and no per-item machinery (admission
        # queues, per-decision tracing) owns the submit path
        batching = (self.batcher is not None and self.resilience is None
                    and self._tracer is None)
        i = 0
        n = len(trace)
        arrivals = list(trace)
        while i < n:
            a = arrivals[i]
            j = i + 1
            if batching:
                while (j < n and arrivals[j].t == a.t
                       and arrivals[j].zone == a.zone):
                    j += 1
            if j - i >= 2:
                group = [(arrivals[k], f"a{k}") for k in range(i, j)]
                self.sim.at(a.t, lambda g=group: self._submit_wave(g))
            else:
                aid = f"a{i}"
                self.sim.at(a.t, lambda a=a, aid=aid: self.submit(
                    a, arrival_id=aid))
            i = j

    def _submit_wave(self, group) -> None:
        """Dispatch one same-tick arrival group through the wave batcher:
        one fused decide for the whole group, with the per-item dispatch
        body (allocate + container charge) run as the wave's commit
        callback — each decision lands before the next is made, exactly
        like the sequential path, so pool warmth and tag occupancy stay
        bit-identical to per-arrival submission."""
        fs = [a.function for a, _aid in group]

        def commit(k, f, w):
            a, aid = group[k]
            self._dispatch(a, aid, None, pre_worker=w)

        self.batcher(fs, zone=group[0][0].zone, commit=commit)

    # ------------------------------------------------------------------ #

    def _pending_tags(self, arrival: Arrival) -> List[str]:
        tag = self.sim.registry[arrival.function].tag
        tags = [tag] + affine_terms_of(self.script, tag)
        for child, _n in arrival.children:
            ct = self.sim.registry[child].tag
            if ct not in tags:
                tags.append(ct)
        return tags

    def submit(self, arrival: Arrival, arrival_id: Optional[str] = None,
               root_t: Optional[float] = None, attempt: int = 1) -> None:
        if self.resilience is None:
            self._dispatch(arrival, arrival_id, root_t, attempt)
            return
        sim = self.sim
        tenant = arrival.tenant if arrival.tenant is not None \
            else DEFAULT_TENANT
        # admission guards *root first attempts* only: DAG children are
        # work the platform already accepted, retries were admitted once
        if (self._admission is not None and attempt == 1
                and root_t is None):
            depth = self._queue.depth if self._queue is not None else 0
            ok, _reason = self._admission.admit(
                tenant, arrival.function, sim.now, queue_depth=depth)
            if not ok:
                self._record_shed(arrival, arrival_id, attempt)
                return
        if self._queue is not None:
            # the forecaster sees the true arrival process, not the pump's
            # dispatch times (a queued arrival is observed exactly once)
            if self.forecast is not None:
                self.forecast.observe(arrival.function, sim.now)
            anchor = root_t if root_t is not None else sim.now
            item = (arrival, arrival_id, anchor, attempt)
            cost = self.compute.get(arrival.function, 0.0)
            if not self._queue.push(tenant, item, cost):
                self.resilience.queue_shed += 1
                self._record_shed(arrival, arrival_id, attempt)
                return
            self._pump()
            return
        self._dispatch(arrival, arrival_id, root_t, attempt)

    def _record_shed(self, arrival: Arrival, arrival_id: Optional[str],
                     attempt: int) -> None:
        t = self.sim.now
        self.records.append(InvocationRecord(
            arrival.function, "<shed>", t, float("nan"), "shed", True,
            arrival.zone, arrival_id, t, None, None, arrival.tenant,
            attempt))

    def _pump(self) -> None:
        """Drain the fair queue in virtual-finish-tag order while the
        scheduler accepts work.  An undispatchable head is put back and
        pumping stops — re-triggered on every completion, heal, and push
        (work-conserving backpressure instead of a failure record)."""
        q = self._queue
        if q is None or self._pumping:
            return
        self._pumping = True
        try:
            while True:
                head = q.pop()
                if head is None:
                    return
                tenant, tag, seq, item = head
                arrival, arrival_id, anchor, attempt = item
                if not self._dispatch(arrival, arrival_id, anchor, attempt,
                                      queued=True):
                    q.requeue_front(tenant, tag, seq, item)
                    return
        finally:
            self._pumping = False

    def _dispatch(self, arrival: Arrival, arrival_id: Optional[str],
                  root_t: Optional[float], attempt: int = 1,
                  queued: bool = False, pre_worker=_UNSET) -> bool:
        """Schedule + allocate + charge one invocation (the historical
        submit body).  Returns False when the scheduler has no worker —
        with a queue the caller requeues; without one a failure record is
        written (the historical behaviour).  ``pre_worker`` carries a
        wave-batched decision (including ``None`` = unplaceable): the
        scheduler call is skipped, everything else runs unchanged."""
        sim = self.sim
        f = arrival.function
        t0 = sim.now
        # attribution window anchor: chained children (and queued/retried
        # submissions) charge the span back to the root arrival of their
        # chain as parent_wait
        t_root = root_t if root_t is not None else t0
        if self.forecast is not None and not queued:
            self.forecast.observe(f, t0)
        tr = self._tracer
        if tr is not None and not self._place_traces:
            tr.begin(t0, f, arrival.zone)
        # zone-stamped arrivals (multi-region traces) carry their origin to
        # the scheduler — Platform.placer accepts zone=; plain callables
        # without the keyword keep working for zone-agnostic traces
        if pre_worker is not _UNSET:
            w = pre_worker
        elif arrival.zone is not None:
            w = self.schedule(f, zone=arrival.zone)
        else:
            w = self.schedule(f)
        if w is None:
            if tr is not None and not self._place_traces:
                tr.decision(t0, f, None, arrival.zone)
            if queued:
                return False
            sim.failures.append(f)
            self.records.append(InvocationRecord(f, "<unschedulable>", t0,
                                                 float("nan"), "failed", True,
                                                 arrival.zone, arrival_id,
                                                 t_root, None, None,
                                                 arrival.tenant, attempt))
            return False
        act = sim.state.allocate(f, w, sim.registry)
        start = sim.container_start(f, w, act.activation_id)
        kind = sim.last_start_kind if sim.pool is not None else "none"
        if tr is not None:
            tr.invoke(act.activation_id, t0, f, w, kind, start, arrival.zone)
        pending = self._pending_tags(arrival)
        if sim.pool is not None:
            sim.pool.pending_add(pending)
        res = self.resilience
        if res is not None and res.ledger is not None and attempt == 1:
            res.ledger.note_admitted(
                arrival.tenant if arrival.tenant is not None
                else DEFAULT_TENANT)
        self._inflight[act.activation_id] = _Inflight(
            arrival, arrival_id, t_root, attempt, pending, t0, w)
        # phase boundary stamps for attribution — the same terms the event
        # schedule below charges, split by name.  The compute-begin stamp
        # is taken when the compute event fires (the service phase's left
        # edge); service then absorbs the exact-sum float residue.
        sched_cost, zone_cost = sim.overhead_parts(w)
        t_exec = [t0]

        def finish():
            if self._inflight.pop(act.activation_id, None) is None:
                return  # the worker died under this activation
            if self.forecast is not None:
                # container-held time on the *warm* path: the start cost is
                # excluded (a prewarmed replacement never pays it — keeping
                # it in would double-count startup in the planner's sizing)
                self.forecast.observe_service(f, sim.now - t0 - start)
            # children first, so their tags take over the pending demand
            # before the parent's refcounts drop
            spawn_idx: Dict[str, int] = {}
            for child, n in arrival.children:
                if self.forecast is not None:
                    self.forecast.observe_edge(f, child, n, sim.now - t0)
                for _ in range(n):
                    k = spawn_idx.get(child, 0)
                    spawn_idx[child] = k + 1
                    cid = (f"{arrival_id}/{child}{k}"
                           if arrival_id is not None else None)
                    self.submit(Arrival(t=sim.now, function=child,
                                        tenant=arrival.tenant),
                                arrival_id=cid, root_t=t_root)
            if sim.pool is not None:
                sim.pool.pending_done(pending)
            sim.container_release(act.activation_id)
            sim.state.complete(act.activation_id)
            if tr is not None:
                tr.complete(act.activation_id, sim.now)
            latency = sim.now - t0
            components = build_attribution(
                sched=sched_cost, boot=start, migrate=0.0,
                route=zone_cost + route, service=sim.now - t_exec[0],
                parent_wait=t0 - t_root, latency=latency)
            record = InvocationRecord(f, w, t0, latency, kind, False,
                                      arrival.zone, arrival_id, t_root,
                                      components, act.activation_id,
                                      arrival.tenant, attempt)
            self.records.append(record)
            if self._attr is not None:
                self._attr.observe(record, zone=sim.workers[w].zone)
            if self._slo is not None:
                self._slo.observe(f, sim.now, latency)
            if self._queue is not None:
                self._pump()  # capacity freed — drain queued arrivals

        def begin_compute():
            if act.activation_id not in self._inflight:
                return  # boot outlived its worker (killed before compute)
            t_exec[0] = sim.now
            sim.compute(f, w, self.compute.get(f, 0.0), act.activation_id,
                        finish)

        # cross-zone front-door routing (zone-stamped arrivals only)
        route = sim.route_cost(arrival.zone, w)
        sim.after(sim.overhead(w) + start + route, begin_compute)
        return True

    # ------------------------------------------------------------------ #
    # chaos entry points (ChaosHarness fires these)
    # ------------------------------------------------------------------ #

    def fail_worker(self, worker: str) -> List[LostActivation]:
        """Kill a worker through the simulator and *handle* the work it
        was running: pending-tag refcounts are released, each lost
        activation is either re-submitted under the retry policy (capped
        backoff, per-tenant retry budget, hedge-once) or recorded as
        ``"lost"`` — the dropped-work contract, honoured."""
        sim = self.sim
        lost_acts = sim.fail_worker(worker)
        out: List[LostActivation] = []
        for act in lost_acts:
            info = self._inflight.pop(act.activation_id, None)
            if info is None:
                continue
            if sim.pool is not None:
                sim.pool.pending_done(info.pending)
            tenant = (info.arrival.tenant if info.arrival.tenant is not None
                      else DEFAULT_TENANT)
            out.append(LostActivation(act.activation_id, act.function,
                                      act.tag, worker, tenant,
                                      sim.now - info.t0))
            self._handle_loss(info, act, tenant)
        self._pump()
        return out

    def fail_zone(self, zone: str) -> List[LostActivation]:
        """Kill every alive worker of ``zone`` (a region outage)."""
        out: List[LostActivation] = []
        dead = set(self.sim.dead_workers)
        for w, spec in self.sim.workers.items():
            if spec.zone == zone and w not in dead:
                out.extend(self.fail_worker(w))
        return out

    def heal_worker(self, worker: str) -> None:
        self.sim.heal_worker(worker)
        self._pump()  # fresh capacity — drain the backlog

    def heal_zone(self, zone: str) -> None:
        for w, spec in self.sim.workers.items():
            if spec.zone == zone:
                self.sim.heal_worker(w)  # no-op for alive workers
        self._pump()

    def _handle_loss(self, info: _Inflight, act, tenant: str) -> None:
        res = self.resilience
        if self._retry is not None:
            pol = res.policy(tenant)
            if (info.attempt < pol.max_attempts
                    and res.ledger.allowed(tenant, pol)):
                res.ledger.note_retry(tenant)
                delay = self._retry.delay(info.attempt + 1)
                arrival, aid = info.arrival, info.arrival_id
                anchor, nxt = info.t_root, info.attempt + 1
                self.sim.at(self.sim.now + delay,
                            lambda: self.submit(arrival, arrival_id=aid,
                                                root_t=anchor, attempt=nxt))
                return
        # no rescue left: an honest loss record instead of silence
        self.permanent_lost += 1
        if res is not None:
            res.permanent_lost += 1
        self.records.append(InvocationRecord(
            act.function, info.worker, info.t0, float("nan"), "lost", True,
            info.arrival.zone, info.arrival_id, info.t_root, None,
            act.activation_id, info.arrival.tenant, info.attempt))
