"""Multi-tenant serving controller: aAPP-driven placement of model work onto
TPU cells (DESIGN.md §2 mapping).

The engine *synthesises aAPP policies programmatically* (the paper's §II notes
platforms may synthesise scripts from workflow knowledge) and evaluates them
with the exact Listing-1 machinery:

* every deployed model M contributes a residency tag ``model:M`` (a long-lived
  pseudo-function pinned on the cells holding M's weights) — prefill/decode
  for M are *affine* to it (code locality / cold-start avoidance);
* a prefill for session s allocates a persistent ``kv:s`` pseudo-function on
  the chosen cell — decodes for s are *affine* to it (the paper's session
  locality: the KV cache is the "open DB connection");
* latency-class isolation is *anti-affinity*: ``decode`` requests refuse cells
  hosting ``train`` or ``heavy-prefill`` work, exactly like `divide`/`impera`
  vs `heavy` in §II.

Fault tolerance: heartbeat-based failure detection; a dead cell simply leaves
``conf`` (Listing 1 line 19 handles the rest) and its sessions are re-prefilled
elsewhere.  Stragglers are hedged with a duplicate request whose policy block
explicitly lists every cell *except* the straggler's, so the hedge lands on a
different cell without anti-affining against unrelated decode traffic.

Container warmth (optional): with a :class:`repro_torch.pool.WarmPool` attached the
engine (a) charges each request its cold/warm/hot container start, (b)
publishes ``warm:<function>`` residency tags into ``conf`` whenever a
(cell, function) pool goes non-empty — so synthesised (or hand-written)
Listing-1 policies can steer toward warm cells — and (c) passes the pool's
warmth rank to the scheduler as a tie-breaker among otherwise-valid cells.

Forecasting (optional; the forecast module is not ported yet, so the
estimator is any object with ``observe`` and ``observe_service``): with one
attached the engine reports every request-class arrival and its service time
to the estimator, and ``forecast_stats()`` exposes the per-class forecast
state (rates, expected arrivals, learned service times and DAG successors)
for dashboards and external planners.
"""
from __future__ import annotations

import dataclasses
import itertools
import random
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core import (
    AAppScript,
    Affinity,
    Block,
    Invalidate,
    TagPolicy,
)
from repro_torch.core.deprecation import warn_once
from repro_torch.cluster.topology import CellSpec, zone_map
from repro_torch.platform import Platform
from repro_torch.pool import WarmPool

TRAIN_TAG = "train"
PREFILL_TAG_PREFIX = "prefill"
DECODE_TAG_PREFIX = "decode"


def _chain(first: Callable[[str, str, str], None],
           second: Optional[Callable[[str, str, str], None]]):
    if second is None:
        return first

    def hook(worker: str, fname: str, tag: str) -> None:
        first(worker, fname, tag)
        second(worker, fname, tag)

    return hook


@dataclasses.dataclass
class Request:
    model: str
    kind: str  # prefill | decode | train
    session: Optional[str] = None
    payload: Any = None
    rid: str = ""
    submitted_at: float = 0.0
    hedged: bool = False


@dataclasses.dataclass
class Completion:
    rid: str
    cell: str
    ok: bool
    latency: float
    result: Any = None
    hedge_won: bool = False


class Engine:
    """The serving controller, as a consumer of the
    :class:`repro_torch.platform.Platform` facade.

    New call shape: build the platform first (it owns the cluster state,
    registry, pool/forecast attachments, rng, and the incremental
    scheduling session) and hand it in::

        plat = Platform(cluster={n: s.hbm_gb for n, s in cells.items()},
                        pool=pool, clock=clock, seed=0)
        eng = Engine(cells, platform=plat, runner=runner)

    The v1 shape — ``Engine(cells, pool=..., forecast=...)`` with the engine
    hand-wiring state + registry + session itself — keeps working as a shim
    (it builds the platform internally) and emits a DeprecationWarning once.

    In the port, the platform the v1 shape builds decides on ``device``
    (``"cuda"``, the default: the affinity kernels; ``"cpu"``: their plain
    PyTorch versions).  A platform passed in keeps its own device.
    """

    def __init__(self, cells: Dict[str, CellSpec], *,
                 platform: Optional[Platform] = None,
                 runner: Optional[Callable[[Request, str], Any]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 hedge_after: Optional[float] = None,
                 heartbeat_timeout: float = 10.0,
                 pool: Optional[WarmPool] = None,
                 forecast=None,
                 seed: Optional[int] = None,
                 device="cuda"):
        self.cells = dict(cells)
        if platform is None:
            warn_once(
                "serve.Engine(cells)",
                "Engine(cells, pool=..., forecast=...) is the v1 call shape;"
                " construct a repro_torch.platform.Platform and pass platform=...",
            )
            # the cells' zones ride along (the shared WorkerSpec/CellSpec
            # zone protocol): a multi-pod engine gets the sharded control
            # plane transparently, and its zone-free synthesised policies
            # delegate to the flat path (bit-identical decisions)
            platform = Platform(cluster={n: s.hbm_gb for n, s in cells.items()},
                                zones=zone_map(cells),
                                pool=pool, forecast=forecast,
                                clock=clock, seed=seed if seed is not None
                                else 0, device=device)
        elif pool is not None or forecast is not None:
            raise ValueError("pass pool/forecast to the Platform, not both")
        self.platform = platform
        self.state = platform.state
        self.reg = platform.registry
        self.clock = platform.clock if clock is time.monotonic else clock
        self.runner = runner or (lambda req, cell: None)
        self.hedge_after = hedge_after
        self.heartbeat_timeout = heartbeat_timeout
        self.pool = platform.pool
        self.forecast = platform.forecast
        # per-engine rng: every `strategy: any` draw is seeded (satellite:
        # reproducible end to end); defaults to the platform's own rng
        self.rng = random.Random(seed) if seed is not None else platform.rng
        self._warm_acts: Dict[Tuple[str, str], str] = {}  # (cell, fname) -> act id
        self._containers: Dict[str, str] = {}  # activation id -> container id
        if self.pool is not None:
            # residency tags: warm pools surface as `warm:<fname>` pseudo-
            # functions in conf, visible to every Listing-1 policy; hooks the
            # caller already installed on the pool keep firing afterwards
            self.pool.on_warm = _chain(self._on_warm, self.pool.on_warm)
            self.pool.on_cooled = _chain(self._on_cooled, self.pool.on_cooled)
        self._ids = itertools.count()
        self._heartbeat: Dict[str, float] = {}
        self._sessions: Dict[str, Tuple[str, str]] = {}  # session -> (cell, kv act id)
        self._model_cells: Dict[str, List[str]] = {}
        self._model_acts: Dict[Tuple[str, str], str] = {}
        self._model_mem: Dict[str, float] = {}
        self._persistent: Dict[str, str] = {}  # rid -> activation id (train streams)
        self.completions: List[Completion] = []
        self.relocations: List[Tuple[str, str]] = []  # (session, reason)
        present = set(self.state.workers())
        for name, spec in cells.items():
            if name not in present:
                self.state.add_worker(name, max_memory=spec.hbm_gb,
                                      zone=spec.zone)
            self._heartbeat[name] = self.clock()
        # incremental scheduling data plane (owned by the platform): state
        # tensors maintained by deltas off the ClusterState change feed,
        # compiled rows cached per synthesised script (scripts for the same
        # request class hash-hit)
        self.scheduler = platform.session
        self._tag_compact_at = self.TAG_COMPACT_THRESHOLD
        # observability rides on the platform's attached obs plane
        self._tracer = platform._tracer
        self._last_kind = "none"

    # ------------------------------------------------------------------ #
    # deployment: model residency tags
    # ------------------------------------------------------------------ #

    def deploy(self, model: str, cells: List[str], *, weights_gb: float,
               kv_gb_per_session: float = 1.0, req_gb: float = 0.25) -> None:
        """Pin model weights on cells; register request classes + pseudo-tags."""
        mt = f"model:{model}"
        self.reg.register(f"resident-{model}", memory=weights_gb, tag=mt)
        self.reg.register(f"kvhold-{model}", memory=kv_gb_per_session, tag="")  # per session, retagged
        self._model_mem[model] = kv_gb_per_session
        self.reg.register(f"{PREFILL_TAG_PREFIX}-{model}", memory=req_gb,
                          tag=f"{PREFILL_TAG_PREFIX}:{model}")
        self.reg.register(f"{DECODE_TAG_PREFIX}-{model}", memory=req_gb,
                          tag=f"{DECODE_TAG_PREFIX}:{model}")
        self.reg.register("train-job", memory=req_gb, tag=TRAIN_TAG)
        self._model_cells[model] = list(cells)
        for c in cells:
            act = self.state.allocate(f"resident-{model}", c, self.reg)
            self._model_acts[(model, c)] = act.activation_id

    # ------------------------------------------------------------------ #
    # warm-pool residency tags
    # ------------------------------------------------------------------ #

    def _on_warm(self, cell: str, fname: str, tag: str) -> None:
        pseudo = f"warm-{fname}"
        if pseudo not in self.reg:
            self.reg.register(pseudo, memory=0.0, tag=f"warm:{fname}")
        if cell in self.state.workers():
            act = self.state.allocate(pseudo, cell, self.reg)
            self._warm_acts[(cell, fname)] = act.activation_id

    def _on_cooled(self, cell: str, fname: str, tag: str) -> None:
        act = self._warm_acts.pop((cell, fname), None)
        if act is not None:
            self.state.complete(act)

    def _container_acquire(self, fname: str, req: Request, cell: str,
                           activation_id: str) -> float:
        """Charge the container start for this invocation (0.0 without a pool
        or for long-lived train streams)."""
        if self.pool is None or req.kind == "train":
            self._last_kind = "none"
            return 0.0
        spec = self.reg[fname]
        c, kind, cost = self.pool.acquire(fname, cell, self.clock(),
                                          memory=spec.memory, tag=spec.tag)
        self._last_kind = kind
        self._containers[activation_id] = c.cid
        return cost

    def _container_release(self, activation_id: str) -> None:
        if self.pool is None:
            return
        cid = self._containers.pop(activation_id, None)
        if cid is not None:
            self.pool.release(cid, self.clock())

    # ------------------------------------------------------------------ #
    # policy synthesis (aAPP as the placement language)
    # ------------------------------------------------------------------ #

    def _policy_for(self, req: Request, *,
                    exclude_cell: Optional[str] = None) -> AAppScript:
        policies = []
        mt = f"model:{req.model}" if req.model else None
        fname = f"{req.kind}-{req.model}" if req.kind != "train" else "train-job"
        if req.kind == "decode":
            tag = f"{DECODE_TAG_PREFIX}:{req.model}"
            terms = []
            if exclude_cell is not None:
                # a hedge cannot chase the session's KV (it lives on the slow
                # cell) — fall back to model residency on any *other* cell.
                # Only the straggler's cell is excluded: anti-affining the
                # decode tag itself would rule out every cell serving decode
                # traffic for this model, not just the straggler.
                if mt:
                    terms.append(mt)
            elif req.session and req.session in self._sessions:
                terms.append(f"kv:{req.session}")  # session locality (affinity)
            elif mt:
                terms.append(mt)
            terms.append("!" + TRAIN_TAG)  # SLO isolation (anti-affinity)
            workers = ("*",) if exclude_cell is None else tuple(
                c for c in self.state.workers() if c != exclude_cell)
            if not workers:
                # no other cell alive: the wildcard can only re-pick the
                # straggler, which submit() discards (cell2 == cell)
                workers = ("*",)
            blocks = (Block(workers=workers,
                            affinity=Affinity.from_terms(terms)),)
            if self.pool is not None:
                # steer toward cells holding a warm container for this class
                blocks = (Block(workers=workers,
                                affinity=Affinity.from_terms(
                                    terms + [f"warm:{fname}"])),) + blocks
            # fallback: allow co-location with train rather than failing
            fb = (Block(workers=workers,
                        affinity=Affinity.from_terms([t for t in terms
                                                      if not t.startswith("!" + TRAIN_TAG)])),)
            policies.append(TagPolicy(tag=tag, blocks=blocks + fb, followup="fail"))
        elif req.kind == "prefill":
            tag = f"{PREFILL_TAG_PREFIX}:{req.model}"
            terms = ([mt] if mt else []) + ["!" + TRAIN_TAG]
            blocks = (Block(workers=("*",),
                            invalidate=Invalidate(capacity_used=95.0),
                            affinity=Affinity.from_terms(terms)),)
            if self.pool is not None:
                blocks = (Block(workers=("*",),
                                invalidate=Invalidate(capacity_used=95.0),
                                affinity=Affinity.from_terms(
                                    terms + [f"warm:{fname}"])),) + blocks
            # fallback: tolerate train co-location rather than failing
            fb = (Block(workers=("*",),
                        invalidate=Invalidate(capacity_used=95.0),
                        affinity=Affinity.from_terms([mt] if mt else [])),)
            policies.append(TagPolicy(tag=tag, blocks=blocks + fb, followup="fail"))
        else:  # train
            blocks = (Block(workers=("*",),
                            affinity=Affinity.from_terms(
                                ["!" + f"{DECODE_TAG_PREFIX}:{m}" for m in self._model_cells]
                                or [])) if self._model_cells else
                      Block(workers=("*",)),)
            policies.append(TagPolicy(tag=TRAIN_TAG, blocks=blocks, followup="default"))
        return AAppScript(policies=tuple(policies))

    # ------------------------------------------------------------------ #
    # request lifecycle
    # ------------------------------------------------------------------ #

    def submit(self, req: Request) -> Completion:
        req.rid = req.rid or f"r{next(self._ids)}"
        req.submitted_at = self.clock()
        self.check_health()
        fname = f"{req.kind}-{req.model}" if req.kind != "train" else "train-job"
        if self.forecast is not None and req.kind != "train" and not req.hedged:
            self.forecast.observe(fname, req.submitted_at)
        script = self._policy_for(req)
        tr = self._tracer
        if tr is not None:
            tr.begin(req.submitted_at, fname, None)
        # pool-backed warmth ranks (vectorized via WarmPool.warmth_row)
        warmth = "auto" if req.kind != "train" else None
        cell = self.scheduler.try_schedule(fname, script=script, warmth=warmth,
                                           rng=self.rng)
        if cell is None:
            if tr is not None:
                tr.decision(self.clock(), fname, None, None)
            comp = Completion(req.rid, "<none>", False, 0.0)
            self.completions.append(comp)
            return comp
        act = self.state.allocate(fname, cell, self.reg)
        start_cost = self._container_acquire(fname, req, cell, act.activation_id)
        if tr is not None:
            tr.invoke(act.activation_id, self.clock(), fname, cell,
                      self._last_kind, start_cost, None)
        t0 = self.clock()
        result = self.runner(req, cell)
        run_latency = self.clock() - t0
        latency = run_latency + start_cost
        if self.forecast is not None and req.kind != "train":
            self.forecast.observe_service(fname, run_latency)

        if req.kind == "train":
            # training jobs are long-lived streams: the allocation persists
            # (and keeps exerting anti-affinity) until stop() is called
            self._persistent[req.rid] = act.activation_id
            comp = Completion(req.rid, cell, True, latency, result)
            self.completions.append(comp)
            return comp

        hedge_won = False
        # hedge on the runner time only: a cold start inflates latency in a
        # way no hedge can beat (it pays its own container start elsewhere)
        if (self.hedge_after is not None and run_latency > self.hedge_after
                and req.kind == "decode" and not req.hedged):
            # straggler: hedge on any cell but the straggler's own
            hedge = dataclasses.replace(req, hedged=True, rid=req.rid + "-hedge")
            script2 = self._policy_for(hedge, exclude_cell=cell)
            cell2 = self.scheduler.try_schedule(fname, script=script2,
                                                warmth=warmth, rng=self.rng)
            if cell2 is not None and cell2 != cell:
                act2 = self.state.allocate(fname, cell2, self.reg)
                start2 = self._container_acquire(fname, hedge, cell2,
                                                 act2.activation_id)
                t1 = self.clock()
                result2 = self.runner(hedge, cell2)
                l2 = self.clock() - t1 + start2
                self._container_release(act2.activation_id)
                self.state.complete(act2.activation_id)
                if l2 < latency:
                    result, hedge_won = result2, True

        self._container_release(act.activation_id)
        self.state.complete(act.activation_id)
        if tr is not None:
            tr.complete(act.activation_id, self.clock())
        if req.kind == "prefill" and req.session:
            self._bind_session(req.session, req.model, cell)
        comp = Completion(req.rid, cell, True, latency, result, hedge_won)
        self.completions.append(comp)
        return comp

    def _bind_session(self, session: str, model: str, cell: str) -> None:
        old = self._sessions.get(session)
        if old is not None:
            self.state.complete(old[1])
        kv_name = f"kv-{session}"
        if kv_name not in self.reg:
            self.reg.register(kv_name, memory=self._model_mem.get(model, 1.0),
                              tag=f"kv:{session}")
        act = self.state.allocate(kv_name, cell, self.reg)
        self._sessions[session] = (cell, act.activation_id)

    def session_cell(self, session: str) -> Optional[str]:
        got = self._sessions.get(session)
        return got[0] if got else None

    def explain(self, req: Request):
        """Explain-trace for the placement ``submit(req)`` *would* make:
        synthesises the request's aAPP policy and runs the scalar reference
        with tracing on the live conf (no allocation, no rng consumed from
        the engine).  Returns a :class:`repro_torch.core.Decision`."""
        from repro_torch.core import explain as _explain

        fname = f"{req.kind}-{req.model}" if req.kind != "train" else "train-job"
        warmth_fn = None
        if self.pool is not None and req.kind != "train":
            now, pool = self.clock(), self.pool
            warmth_fn = lambda f, w: pool.warmth(f, w, now)
        return _explain(fname, self.state.conf(), self._policy_for(req),
                        self.reg, rng=random.Random(0), warmth=warmth_fn)

    def forecast_stats(self, horizon: float = 1.0) -> Dict[str, Dict]:
        """Per-request-class forecast state (empty without an estimator).
        Shape owned by :func:`repro_torch.obs.schema.forecast_stats`."""
        from repro_torch.obs.schema import forecast_stats
        return forecast_stats(self.forecast, self.clock(), horizon)

    # ------------------------------------------------------------------ #
    # fault tolerance / elasticity
    # ------------------------------------------------------------------ #

    def stop(self, rid: str) -> None:
        """End a persistent (train) job: completion notification semantics."""
        act = self._persistent.pop(rid, None)
        if act is not None:
            self.state.complete(act)

    def heartbeat(self, cell: str) -> None:
        self._heartbeat[cell] = self.clock()

    # per-session kv tags accumulate in the scheduler's append-only tag
    # universe; past this size the health tick compacts it (dropped sessions'
    # columns are reclaimed, caches recompile on demand)
    TAG_COMPACT_THRESHOLD = 512

    def check_health(self) -> List[str]:
        now = self.clock()
        if len(self.scheduler.tag_index) >= self._tag_compact_at:
            self.scheduler.compact()
            self.scheduler.tensors()  # rebuild now: resident tags re-enter
            # hysteresis: if the index is dominated by *live* tags, compacting
            # cannot shrink it — back the trigger off so a sustained-high-
            # concurrency engine doesn't drop every cache on every tick
            self._tag_compact_at = max(self.TAG_COMPACT_THRESHOLD,
                                       2 * len(self.scheduler.tag_index))
        if self.pool is not None:
            self.pool.sweep(now)  # piggyback the janitor on the health tick
        dead = [c for c, t in self._heartbeat.items()
                if now - t > self.heartbeat_timeout and c in self.state.workers()]
        for c in dead:
            self.fail_cell(c)
        return dead

    def fail_cell(self, cell: str) -> List[str]:
        """Cell crash: evict state, re-home sessions (their KV is lost — they
        need a fresh prefill, which the aAPP policy places on a surviving
        cell), and re-pin model residency where replicas are configured."""
        self.state.fail_worker(cell)
        self._heartbeat.pop(cell, None)
        if self.pool is not None:
            # evict_worker drains every idle list for the cell; the on_cooled
            # callbacks retire the matching warm:<fn> residency activations
            self.pool.evict_worker(cell)
        moved = []
        for session, (c, _act) in list(self._sessions.items()):
            if c == cell:
                model = next((m for m, cs in self._model_cells.items() if cell in cs),
                             None)
                del self._sessions[session]
                self.relocations.append((session, f"cell {cell} failed"))
                if model is not None:
                    comp = self.submit(Request(model=model, kind="prefill",
                                               session=session))
                    if comp.ok:
                        moved.append(session)
        for (model, c), _ in list(self._model_acts.items()):
            if c == cell:
                self._model_acts.pop((model, c))
                self._model_cells[model] = [x for x in self._model_cells[model]
                                            if x != cell]
        return moved

    def add_cell(self, spec: CellSpec) -> None:
        self.cells[spec.name] = spec
        self.state.add_worker(spec.name, max_memory=spec.hbm_gb,
                              zone=spec.zone)
        self._heartbeat[spec.name] = self.clock()

    def drain_cell(self, cell: str) -> List[str]:
        """Graceful removal: same re-homing path as failure."""
        return self.fail_cell(cell)
