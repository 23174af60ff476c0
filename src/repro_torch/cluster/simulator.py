"""Discrete-event simulator of the paper's §V testbed.

Models, explicitly, every latency mechanism the paper attributes its results
to:

* **processor-sharing contention**: a worker's vCPUs are shared equally among
  resident compute phases — co-location with `heavy` slows `divide`/`impera`
  down (the anti-affinity motivation);

  Two interchangeable compute cores implement it.  The default ``virtual``
  core runs on *per-worker virtual time*: each worker keeps a virtual
  work clock that advances at the current per-task service rate, a task's
  completion is a fixed point on that clock (``vclock_at_add + work``), and
  completions live in a per-worker heap keyed by virtual finish time.  Task
  progress is advanced lazily, only for workers actually touched by an
  event, and completion events are armed per worker with a freshness token —
  per-event cost is O(log n) instead of the ``legacy`` core's O(workers x
  tasks) full-cluster scan (kept, selectable via ``engine="legacy"``, as the
  reference for the ``benchmarks/simperf.py`` before/after comparison).
  Both cores integrate delivered compute per worker (``delivered_work``) so
  conservation — total delivered equals total task work — is testable;
* **session locality**: the first connection a worker opens to its zone's
  storage replica costs ``conn_setup``; later functions on the same worker
  reuse it (the affinity motivation, §II);
* **eventual consistency**: a document written in zone A becomes visible in
  zone B after a sampled replication lag; `divide` polls its *local* replica
  with exponential back-off (1 s base, doubling — §V) and counts retries;
* **control-plane asymmetry**: OpenWhisk core components live in the EU zone,
  so invocations on US workers pay an extra overhead (the paper's observed
  EU/US latency gap);
* **container lifecycle** (optional): when a :class:`repro_torch.pool.WarmPool` is
  attached, every invocation is charged its cold/warm/hot start latency via
  ``container_start`` and returns its container to the pool via
  ``container_release``; the pool's janitor runs as events on the simulator's
  heap, firing exactly when the keep-alive policy can next expire a
  container.  Without a pool the simulator behaves as before (zero start
  cost) — the seed's §V experiments are unchanged;
* **predictive control plane** (optional): with a
  :class:`repro_torch.forecast.ForecastPlanner` attached alongside the pool, a
  planning epoch fires every ``plan_interval`` simulated seconds on the same
  event heap.  Prewarm actions boot in the background and park their idle
  container a full cold-start latency later; migrations detach the container
  from its source immediately and re-attach it at the destination after
  ``migrate_cost`` (between a warm unpause and a cold create); planner
  retirements apply instantly.  Epochs stop re-arming once no other events
  or compute remain, so ``run()`` still terminates.

Scheduling decisions are delegated to a pluggable ``scheduler_fn`` driven by
the *real* aAPP machinery (`repro_torch.core`): the simulator maintains a
``ClusterState`` and calls the scheduler exactly when OpenWhisk's load
balancer would.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import random
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.state import ClusterState, Registry
from repro_torch.pool import WarmPool
from .topology import WorkerSpec, ZoneTopology


@dataclasses.dataclass(frozen=True)
class SimParams:
    invoke_overhead: float = 0.05  # platform routing cost (s)
    us_overhead: float = 0.35  # extra cost when the worker is cross-zone
    conn_setup: float = 0.30  # new DB connection per (worker, replica)
    impera_compute: float = 0.8  # single-vCPU seconds
    divide_compute: float = 0.3
    heavy_compute: float = 120.0
    sync_lag_median: float = 0.02  # cross-zone replication lag (lognormal)
    sync_lag_sigma: float = 2.0
    # co-tenancy pressure on the 1-vCPU node class (the DB replicas run on the
    # same class — Fig. 7) multiplies replication lag: MongoDB apply-queues
    # grow under resource contention.  This reproduces APP's deep retry
    # ladders (§V's ~60 s p95) while anti-affine policies, which keep
    # divide/impera off the small nodes, only ever see baseline lag.
    lag_load_factor: float = 40.0
    notify_delay: float = 0.06  # completion ack via the control plane
    backoff_base: float = 1.0  # §V: 1 s, doubling
    max_retries: int = 8
    docs_per_impera: int = 50
    # request-routing cost when a zone-stamped arrival lands on a worker in
    # another zone (multi-region traces only; zone-agnostic arrivals are
    # never charged, preserving the seed's single-front-door model)
    cross_zone_route: float = 0.15


class _Task:
    _ids = itertools.count()
    __slots__ = ("id", "fname", "worker", "on_done", "activation_id",
                 "work", "remaining", "vfinish", "eta_token")

    def __init__(self, fname: str, worker: str, on_done: Callable, activation_id: str):
        self.id = next(self._ids)
        self.fname = fname
        self.worker = worker
        self.on_done = on_done
        self.activation_id = activation_id
        self.work = 0.0  # single-cpu seconds of compute total
        self.remaining = 0.0  # legacy core: compute left
        self.vfinish = 0.0  # virtual core: finish point on the worker vclock
        self.eta_token = 0  # legacy core: freshness of the armed completion


class _VirtualWorker:
    """Per-worker virtual-time processor-sharing state (the O(log n) core).

    ``vclock`` measures *per-task service received*: it advances at rate
    ``min(1, vcpus/n)`` in real time, so a task entering at ``vclock = v``
    with ``work`` cpu-seconds finishes exactly when ``vclock`` reaches
    ``v + work`` — a fixed point, unaffected by later membership changes.
    Membership changes only bend the real-time slope, which is handled by
    re-arming the worker's next completion event (token-guarded)."""

    __slots__ = ("name", "vcpus", "n", "vclock", "last_t", "heap", "token",
                 "delivered")

    def __init__(self, name: str, vcpus: float):
        self.name = name
        self.vcpus = vcpus
        self.n = 0
        self.vclock = 0.0
        self.last_t = 0.0
        self.heap: List[Tuple[float, int, _Task]] = []  # (vfinish, id, task)
        self.token = 0
        self.delivered = 0.0  # cpu-seconds actually served (conservation)

    def rate(self) -> float:
        if self.n == 0:
            return 0.0
        return min(1.0, self.vcpus / self.n)

    def touch(self, t: float) -> None:
        dt = t - self.last_t
        if dt > 0.0:
            r = self.rate()
            if r > 0.0:
                self.vclock += r * dt
                self.delivered += self.n * r * dt
        self.last_t = t


class ClusterSim:
    """Event loop + processor-sharing workers + N-zone eventually-consistent DB.

    ``topology`` (optional) is the N-zone latency/replication matrix; when
    omitted it defaults to the seed model over the zones observed in
    ``workers`` (control plane in the ``eu`` zone when present, else the
    first observed zone; every other zone paying ``params.us_overhead``;
    unit replication-lag factors) — bit-identical to the historical
    hard-coded eu/us pair whenever an ``eu`` zone exists."""

    def __init__(self, workers: Dict[str, WorkerSpec], params: SimParams, seed: int = 0,
                 *, pool: Optional[WarmPool] = None, planner=None,
                 plan_interval: float = 2.0, migrate_cost: float = 0.25,
                 engine: str = "virtual",
                 topology: Optional[ZoneTopology] = None):
        if engine not in ("virtual", "legacy"):
            raise ValueError(f"unknown engine {engine!r}")
        self.engine = engine
        self.workers = workers
        self.p = params
        zones = tuple(dict.fromkeys(w.zone for w in workers.values()))
        self.topology = topology if topology is not None else \
            ZoneTopology.default(zones or ("",),
                                 remote_overhead=params.us_overhead)
        self.rng = random.Random(seed)
        self.now = 0.0
        self._heap: List[Tuple[float, int, Callable]] = []
        self._seq = itertools.count()
        self.state = ClusterState()
        for w in workers.values():
            self.state.add_worker(w.name, max_memory=w.memory_mb, zone=w.zone)
        self.registry = Registry()
        # compute cores (processor sharing)
        self._running: Dict[str, List[_Task]] = {w: [] for w in workers}  # legacy
        self._vw: Dict[str, _VirtualWorker] = {
            w: _VirtualWorker(w, spec.vcpus) for w, spec in workers.items()}
        self._n_active = 0  # tasks in flight, both cores
        self._small_pressure = 0  # non-heavy tasks on the 1-vCPU node class
        self._submitted_work: Dict[str, float] = {w: 0.0 for w in workers}
        self._delivered_legacy: Dict[str, float] = {w: 0.0 for w in workers}
        self.stats: Dict[str, int] = {
            "events": 0,  # heap events processed by run()
            "completion_pushes": 0,  # completion events armed
            "stale_completions": 0,  # armed events dropped by token/liveness
        }
        # DB: (index) -> list of (zone, visible_at: {zone: t})
        self._docs: Dict[str, List[Dict[str, float]]] = {}
        self._connections: Dict[Tuple[str, str], bool] = {}
        self.failures: List[str] = []
        # fault injection (chaos harness): workers currently dead, plus the
        # cpu-seconds of compute their deaths destroyed — conservation under
        # chaos is delivered + lost == submitted, per worker
        self._dead: set = set()
        self._lost_work: Dict[str, float] = {}
        # container lifecycle (optional)
        self.pool = pool
        self.last_start_kind: Optional[str] = None
        self._containers: Dict[str, str] = {}  # activation_id -> container id
        self._janitor_at: Optional[float] = None
        # predictive control plane (optional; requires a pool)
        self.planner = planner
        self.plan_interval = float(plan_interval)
        self.migrate_cost = float(migrate_cost)
        self._planner_armed = False

    def attach_obs(self, obs) -> None:
        """Register the simulator's event counters (and, lazily, the
        planner's epoch counters — a planner may be attached after
        construction) as snapshot-time collectors."""
        obs.registry.register_collector("sim", lambda: dict(self.stats))

        def _planner_stats():
            p = self.planner
            if p is not None and hasattr(p, "stats"):
                return dict(p.stats)
            return {}

        obs.registry.register_collector("planner", _planner_stats)

    # ---- event machinery -------------------------------------------------- #

    def at(self, t: float, fn: Callable) -> None:
        heapq.heappush(self._heap, (max(t, self.now), next(self._seq), fn))

    def after(self, dt: float, fn: Callable) -> None:
        self.at(self.now + dt, fn)

    def run(self) -> None:
        if (self.planner is not None and self.pool is not None
                and not self._planner_armed):
            self._planner_armed = True
            self.at(self.now + self.plan_interval, self._planner_tick)
        legacy = self.engine == "legacy"
        while self._heap:
            t, _, fn = heapq.heappop(self._heap)
            self.stats["events"] += 1
            if legacy:
                self._advance_compute(t)
            self.now = t
            fn()

    # ---- processor-sharing compute: shared bookkeeping ---------------------- #

    def _is_small_pressure(self, fname: str, worker: str) -> bool:
        return (self.workers[worker].vcpus <= 1
                and not fname.startswith("heavy"))

    def _task_added(self, task: _Task) -> None:
        self._n_active += 1
        if self._is_small_pressure(task.fname, task.worker):
            self._small_pressure += 1

    def _task_removed(self, task: _Task) -> None:
        self._n_active -= 1
        if self._is_small_pressure(task.fname, task.worker):
            self._small_pressure -= 1

    def has_compute(self) -> bool:
        return self._n_active > 0

    def delivered_work(self, worker: str) -> float:
        """CPU-seconds actually served on ``worker`` so far (both cores
        integrate it lazily; conservation-tested against submitted work)."""
        if self.engine == "legacy":
            return self._delivered_legacy.get(worker, 0.0)
        vw = self._vw[worker]
        return vw.delivered + (max(self.now - vw.last_t, 0.0)
                               * vw.rate() * vw.n)

    def submitted_work(self, worker: str) -> float:
        return self._submitted_work.get(worker, 0.0)

    def compute(self, fname: str, worker: str, work: float, activation_id: str,
                on_done: Callable) -> None:
        if worker in self._dead:
            raise RuntimeError(
                f"compute scheduled on failed worker {worker!r} — the "
                "caller must drop or reschedule work for dead workers")
        task = _Task(fname, worker, on_done, activation_id)
        task.work = work
        self._submitted_work[worker] = self._submitted_work.get(worker, 0.0) + work
        if self.engine == "legacy":
            task.remaining = work
            self._running[worker].append(task)
            self._task_added(task)
            self._reschedule_completions()
            return
        vw = self._vw[worker]
        vw.touch(self.now)
        task.vfinish = vw.vclock + work
        heapq.heappush(vw.heap, (task.vfinish, task.id, task))
        vw.n += 1
        self._task_added(task)
        self._arm_worker(vw)

    # ---- virtual-time core (default): O(log n) per event -------------------- #

    def _arm_worker(self, vw: _VirtualWorker) -> None:
        """(Re)arm the worker's next-completion event.  The token invalidates
        any previously armed event for this worker, so membership changes
        never leave duplicate live completions on the heap."""
        if not vw.heap:
            return
        r = vw.rate()
        eta = vw.last_t + max(vw.heap[0][0] - vw.vclock, 0.0) / r
        vw.token += 1
        token = vw.token
        self.stats["completion_pushes"] += 1
        self.at(eta, lambda: self._fire_worker(vw, token))

    def _fire_worker(self, vw: _VirtualWorker, token: int) -> None:
        if token != vw.token:
            self.stats["stale_completions"] += 1
            return
        vw.touch(self.now)
        done: List[_Task] = []
        while vw.heap and vw.heap[0][0] <= vw.vclock + 1e-9:
            _, _, task = heapq.heappop(vw.heap)
            vw.n -= 1
            self._task_removed(task)
            done.append(task)
        self._arm_worker(vw)  # next completion (or float under-run retry)
        for task in done:  # virtual-finish order
            task.on_done()

    # ---- legacy core (reference): O(workers x tasks) full scans -------------- #
    #
    # Kept selectable (``engine="legacy"``) as the before/after baseline for
    # ``benchmarks/simperf.py``.  Fixed relative to its original form: a
    # completion event now carries a per-task scheduled-ETA token, so an
    # event made stale by a rate change is dropped on firing instead of
    # re-entering ``_reschedule_completions`` and pushing yet another
    # duplicate event for the same task (the churn cascade pinned in
    # ``tests/test_simulator_engines.py``).

    def _rates(self, worker: str) -> float:
        n = len(self._running[worker])
        if n == 0:
            return 0.0
        return min(1.0, self.workers[worker].vcpus / n)

    def _advance_compute(self, t: float) -> None:
        dt = t - self.now
        if dt <= 0:
            return
        for w, tasks in self._running.items():
            r = self._rates(w)
            if r <= 0:
                continue
            self._delivered_legacy[w] = (self._delivered_legacy.get(w, 0.0)
                                         + len(tasks) * r * dt)
            for task in tasks:
                task.remaining -= r * dt

    def _reschedule_completions(self) -> None:
        """(Re)arm the earliest completion; the token drops superseded events."""
        best: Optional[Tuple[float, _Task]] = None
        for w, tasks in self._running.items():
            r = self._rates(w)
            if r <= 0:
                continue
            for task in tasks:
                eta = self.now + max(task.remaining, 0.0) / r
                if best is None or eta < best[0]:
                    best = (eta, task)
        if best is not None:
            t, task = best
            task.eta_token += 1
            token = task.eta_token
            self.stats["completion_pushes"] += 1
            self.at(t, lambda: self._maybe_complete(task, token))

    def _maybe_complete(self, task: _Task, token: int) -> None:
        if (token != task.eta_token
                or task not in self._running[task.worker]):
            self.stats["stale_completions"] += 1
            return  # superseded by a later reschedule (rates changed)
        if task.remaining > 1e-9:
            self._reschedule_completions()  # float under-run: rearm
            return
        self._running[task.worker].remove(task)
        self._task_removed(task)
        self._reschedule_completions()
        task.on_done()

    # ---- container lifecycle (warm pool) ------------------------------------ #

    def container_start(self, fname: str, worker: str, activation_id: str) -> float:
        """Acquire a container for the invocation; returns its start latency
        (0.0 when no pool is attached).  The kind of the last start is kept in
        ``last_start_kind`` for workload bookkeeping."""
        if self.pool is None:
            self.last_start_kind = None
            return 0.0
        spec = self.registry[fname]
        c, kind, cost = self.pool.acquire(fname, worker, self.now,
                                          memory=spec.memory, tag=spec.tag)
        self._containers[activation_id] = c.cid
        self.last_start_kind = kind
        return cost

    def container_release(self, activation_id: str) -> None:
        """Park the invocation's container back in the warm pool and (re)arm
        the janitor for its eventual expiry."""
        if self.pool is None:
            return
        cid = self._containers.pop(activation_id, None)
        if cid is not None:
            self.pool.release(cid, self.now)
        self._kick_janitor()

    def _kick_janitor(self) -> None:
        if self.pool is None:
            return
        nxt = self.pool.next_event(self.now)
        if nxt is None:
            return
        if self._janitor_at is not None and self._janitor_at <= nxt:
            return  # an equally-early sweep is already on the heap
        self._janitor_at = nxt
        self.at(nxt, self._janitor_tick)

    def _janitor_tick(self) -> None:
        self._janitor_at = None
        if self.pool is None:
            return
        self.pool.sweep(self.now)
        self._kick_janitor()

    # ---- fault injection (chaos harness) ------------------------------------- #

    def fail_worker(self, worker: str):
        """Kill ``worker`` at the current virtual time: evict its
        activations from the state tables (returned, as
        :meth:`ClusterState.fail_worker` promises, for rescheduling),
        destroy the containers of its in-flight invocations, drain its
        idle containers, and cancel its compute in whichever core is
        active.  The cancelled tasks' ``on_done`` callbacks never fire —
        the caller (the workload driver's loss handler) owns turning the
        returned activations into retries or honest loss records.

        Destroyed compute is accounted in :meth:`lost_work`, keeping the
        conservation invariant ``delivered + lost == submitted``."""
        if worker not in self.workers:
            raise KeyError(f"unknown worker {worker!r}")
        lost = self.state.fail_worker(worker)
        if self.pool is not None:
            for act in lost:
                cid = self._containers.pop(act.activation_id, None)
                if cid is not None:
                    self.pool.destroy(cid)
            self.pool.evict_worker(worker)
        lost_cpu = 0.0
        if self.engine == "legacy":
            for task in self._running.get(worker, ()):
                lost_cpu += max(task.remaining, 0.0)
                self._task_removed(task)
            self._running[worker] = []
            # the single armed completion may have been one of the killed
            # tasks (it would drop as stale without rearming and stall the
            # survivors) — rearm over the remaining population
            self._reschedule_completions()
        else:
            vw = self._vw[worker]
            vw.touch(self.now)
            for _vf, _id, task in vw.heap:
                lost_cpu += max(task.vfinish - vw.vclock, 0.0)
                self._task_removed(task)
            vw.heap.clear()
            vw.n = 0
            vw.token += 1  # any armed completion event is now stale
        if lost_cpu:
            self._lost_work[worker] = \
                self._lost_work.get(worker, 0.0) + lost_cpu
        self._dead.add(worker)
        return lost

    def heal_worker(self, worker: str) -> None:
        """Bring a previously failed worker back (its spec's memory and
        zone re-join the state tables via the ``add_worker`` re-join path).
        A healed worker is a fresh machine: its DB sessions are gone, so
        the first connection per replica pays ``conn_setup`` again.
        No-op when the worker is alive."""
        if worker not in self.workers:
            raise KeyError(f"unknown worker {worker!r}")
        if worker not in self._dead:
            return
        self._dead.discard(worker)
        spec = self.workers[worker]
        self.state.add_worker(worker, max_memory=spec.memory_mb,
                              zone=spec.zone)
        if self.engine != "legacy":
            self._vw[worker].touch(self.now)
        for key in [k for k in self._connections if k[0] == worker]:
            del self._connections[key]

    @property
    def dead_workers(self) -> Tuple[str, ...]:
        return tuple(sorted(self._dead))

    def lost_work(self, worker: str) -> float:
        """CPU-seconds of compute destroyed by killing ``worker`` (the
        conservation ledger's chaos column)."""
        return self._lost_work.get(worker, 0.0)

    # ---- predictive control plane (forecast planner epochs) ------------------ #

    def _planner_tick(self) -> None:
        pool = self.pool
        for a in self.planner.plan(self.state.conf(), pool, self.now):
            kind = type(a).__name__
            if kind == "Prewarm":
                # booting happens in the background: the idle container only
                # becomes available a full cold-start latency from now
                pool.metrics.prewarm_seconds += pool.costs.cold
                self.after(pool.costs.cold, lambda a=a: self._finish_prewarm(a))
            elif kind == "Migrate":
                c = pool.migrate_out(a.function, a.src, self.now)
                if c is not None:
                    pool.metrics.migration_seconds += self.migrate_cost
                    self.after(self.migrate_cost,
                               lambda c=c, a=a: self._finish_migrate(c, a.dst))
            else:  # Retire
                pool.retire_idle(a.function, a.worker, self.now)
        # keep epoching only while the simulation still has work: arrivals or
        # in-flight actions on the heap, or compute in progress
        if self._heap or self.has_compute():
            self.at(self.now + self.plan_interval, self._planner_tick)

    def _finish_prewarm(self, a) -> None:
        # budget re-checked at park time: demand may have filled the worker
        # while the container booted (prewarm refuses rather than evicts)
        self.pool.prewarm(a.function, a.worker, self.now,
                          memory=a.memory, tag=a.tag)
        self._kick_janitor()

    def _finish_migrate(self, c, dst: str) -> None:
        self.pool.migrate_in(c, dst, self.now)
        self._kick_janitor()

    # ---- DB ----------------------------------------------------------------- #

    def db_connect(self, worker: str, replica_zone: Optional[str] = None) -> float:
        """Connection cost for ``worker`` talking to a zone's storage replica
        (session locality, §II: the first connection per *(worker, replica)*
        pays ``conn_setup``; reuse of that same session is free).

        ``replica_zone`` defaults to the worker's local replica.  Keying by
        the *replica* zone — not the worker's own zone, which is a constant
        per worker and would collapse the table to per-worker — means a
        worker that later polls the remote replica pays a fresh setup, as
        the paper's session-locality model states."""
        replica = replica_zone if replica_zone is not None else self.workers[worker].zone
        key = (worker, replica)
        if self._connections.get(key):
            return 0.0
        self._connections[key] = True
        return self.p.conn_setup

    def _small_node_pressure(self) -> int:
        """Non-heavy functions currently computing on the 1-vCPU node class
        (the class the DB replicas share).  O(1): a counter maintained on
        task add/remove rather than a full-cluster scan per ``db_write``."""
        return self._small_pressure

    def db_write(self, index: str, worker: str, n_docs: int) -> None:
        """Write locally; remote replicas converge after the sampled lag
        scaled by the topology's per-pair replication factor (one lag draw
        per write, exactly like the historical 2-zone model)."""
        zone = self.workers[worker].zone
        lag = self.rng.lognormvariate(math.log(self.p.sync_lag_median),
                                      self.p.sync_lag_sigma)
        lag *= 1.0 + self.p.lag_load_factor * self._small_node_pressure()
        entry: Dict[str, float] = {"n": n_docs, zone: self.now}
        for other in self.topology.zones:
            if other != zone:
                entry[other] = self.now + lag * self.topology.factor(zone, other)
        self._docs.setdefault(index, []).append(entry)

    def db_visible(self, index: str, worker: str, expected_docs: int) -> bool:
        zone = self.workers[worker].zone
        docs = self._docs.get(index, [])
        total = sum(d["n"] for d in docs if d.get(zone, float("inf")) <= self.now)
        return total >= expected_docs

    # ---- invocation overheads ------------------------------------------------ #

    def overhead(self, worker: str) -> float:
        # platform routing cost + the zone's distance from the control plane
        # (the paper's EU/US asymmetry, generalised to the N-zone topology)
        return (self.p.invoke_overhead
                + self.topology.overhead_of(self.workers[worker].zone))

    def overhead_parts(self, worker: str) -> Tuple[float, float]:
        """:meth:`overhead` split for latency attribution: the platform
        front-door cost (the ``sched`` component) and the worker zone's
        control-plane distance (charged to ``route``).  Event times keep
        using :meth:`overhead` — same terms, same order — so attribution
        never perturbs the schedule."""
        return (self.p.invoke_overhead,
                self.topology.overhead_of(self.workers[worker].zone))

    def route_cost(self, origin_zone: Optional[str], worker: str) -> float:
        """Extra front-door routing latency for a request that originated in
        ``origin_zone`` but was placed on a worker in another zone.  Zero
        for zone-agnostic arrivals and for local placements — the term the
        sharded ``local_first`` router exists to avoid."""
        if origin_zone is None:
            return 0.0
        if self.workers[worker].zone == origin_zone:
            return 0.0
        return self.p.cross_zone_route
