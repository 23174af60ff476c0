"""The :class:`Platform` facade — one object in front of the aAPP stack.

The seed API leaked its internals: every consumer hand-wired parser →
script → :class:`~repro_torch.core.batched.SchedulerSession` → pool →
engine/simulator.  ``Platform`` owns that wiring:

* a script goes through the full v2 compile pipeline
  (:func:`repro_torch.core.compile.compile_script`: parse → resolve → validate →
  lower) once, and the resulting :class:`~repro_torch.core.compile.CompiledScript`
  IR is adopted by the incremental scheduling session;
* decisions come back as structured :class:`~repro_torch.core.decision.Decision`
  objects (optionally carrying a per-block, per-worker explain-trace via
  :meth:`explain`) instead of bare worker strings;
* randomness is owned: one seeded ``random.Random`` drives every
  ``strategy: any`` draw, so a platform run is reproducible end to end;
* the warm pool, arrival forecast and planner plug in at construction and
  the facade keeps them in lockstep (container starts charged on
  :meth:`invoke`, releases on :meth:`complete`, janitor sweeps and planning
  epochs on :meth:`advance`).

Quick start::

    from repro_torch.platform import Platform

    plat = Platform.from_yaml(SCRIPT, cluster={"w0": 2048, "w1": 2048})
    plat.register("divide", memory=256, tag="d")
    d = plat.invoke("divide")          # Decision(worker=..., activation_id=...)
    print(plat.explain("impera").format())  # why every worker was (in)valid
    plat.complete(d)

The facade is deliberately thin over the hot path — one
``SchedulerSession`` decision + one state allocation per :meth:`invoke`
(the ``benchmarks/overhead.py`` microbench pins the facade tax under 5%,
the paper's "no noticeable overhead" claim applied at the API layer).
High-fidelity timing (background prewarm boots, migration latencies,
processor sharing) stays with :class:`repro_torch.cluster.simulator.ClusterSim`;
:meth:`advance` applies planner actions instantaneously.

In the port, decisions run in float32 on ``device`` (the CUDA kernels on
``"cuda"``, the default; their plain PyTorch versions on ``"cpu"``): they
equal the JAX reference ``Platform(backend="ref")`` bit for bit, and its
float64 ``backend="np"`` everywhere except where float64 rounding breaks a
rational ``min_cost`` tie.  ``backend="np"`` selects the float64 host twin.
The observability (:class:`repro_torch.obs.Obs`) and resilience
(:class:`repro_torch.resilience.Resilience`) bundles attach as in the
reference and leave decisions and rng draws unchanged.
"""
from __future__ import annotations

import random
from typing import (Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple, Union)

from repro_torch.core.ast import AAppError, AAppScript
from repro_torch.core.compile import CompiledScript, compile_script
from repro_torch.core.batched import SchedulerSession
from repro_torch.core.decision import Decision
from repro_torch.core.scheduler import explain as _explain_scalar
from repro_torch.core.sharded import ShardedSession
from repro_torch.core.state import Activation, ClusterState, Registry
from repro_torch.resilience import DEFAULT_TENANT, LostActivation

ClusterLike = Union[None, ClusterState, Mapping[str, float],
                    Iterable[Tuple[str, float]]]


def _as_state(cluster: ClusterLike) -> ClusterState:
    if cluster is None:
        return ClusterState()
    if isinstance(cluster, ClusterState):
        return cluster
    state = ClusterState()
    items = cluster.items() if isinstance(cluster, Mapping) else cluster
    for name, max_memory in items:
        state.add_worker(name, max_memory=float(max_memory))
    return state


class Platform:
    """Facade: ``register / invoke / complete / advance / reload_script /
    explain`` over one compiled script, one cluster state, one session."""

    def __init__(
        self,
        source: Union[None, str, AAppScript, CompiledScript] = None,
        *,
        cluster: ClusterLike = None,
        registry: Optional[Registry] = None,
        functions: Optional[Mapping[str, Tuple[float, str]]] = None,
        pool=None,
        forecast=None,
        planner=None,
        seed: int = 0,
        clock: Optional[Callable[[], float]] = None,
        backend: str = "torch",
        device="cuda",
        zones: Optional[Mapping[str, object]] = None,
        zone_strategy: str = "local_first",
        shard_floor: int = 1024,
        obs=None,
        resilience=None,
    ):
        self.state = _as_state(cluster)
        self.registry = registry if registry is not None else Registry()
        if functions:
            for name, (memory, tag) in functions.items():
                self.registry.register(name, memory=memory, tag=tag)
        self.pool = pool
        self.forecast = forecast
        self.planner = planner
        self.rng = random.Random(seed)
        self._seed = seed
        self._now = 0.0
        self._owns_clock = clock is None
        self.clock: Callable[[], float] = clock or (lambda: self._now)
        if zones:
            # {worker: zone-name} or {worker: WorkerSpec/CellSpec}
            self.state.set_zones(zones)
        self.compiled: Optional[CompiledScript] = None
        zone_set = [z for z in self.state.zones() if z]
        if source is not None:
            if isinstance(source, CompiledScript):
                self.compiled = source
            else:
                self.compiled = compile_script(
                    source, self.registry,
                    zones=zone_set if zone_set else None)
        # sharded control plane when the cluster carries >1 zone AND either
        # the script actually routes (zone terms / topology hints — routing
        # needs shards regardless of size) or the cluster is big enough
        # (>= shard_floor workers) for per-zone tensors to pay for the
        # router.  Below the floor a zone-free script runs on the flat
        # session directly — bit-identical either way, since the sharded
        # plane *delegates* zone-free decisions to its flat sub-session
        # (property-tested)
        self._backend = backend
        self._device = device
        self._zone_strategy = zone_strategy
        self.shard_floor = shard_floor
        self._sharded = len(zone_set) > 1 and (
            self._script_routes()
            or len(self.state.workers()) >= shard_floor)
        if self._sharded:
            self.session: SchedulerSession = ShardedSession(
                self.state, self.registry,
                self.compiled if self.compiled is not None else None,
                backend=backend, device=device, pool=pool, clock=self.clock,
                zone_strategy=zone_strategy)
        else:
            self.session = SchedulerSession(
                self.state, self.registry,
                self.compiled if self.compiled is not None else None,
                backend=backend, device=device, pool=pool, clock=self.clock)
        self._containers: Dict[str, str] = {}  # activation id -> container id
        # observability plane (repro_torch.obs.Obs): the tracer reference is
        # cached so the disabled hot path pays one attribute load + None
        # check per invoke (`overhead.py --obs` pins it under 1%)
        # resilience layer (repro_torch.resilience.Resilience): same
        # cached-None pattern as the tracer — a missing (or disabled) bundle
        # costs the hot path one attribute load + None check (`overhead.py
        # --resilience` pins it under 1%), and decisions + rng draws stay
        # bit-identical (property-tested)
        self.resilience = None
        self._res = None  # the *active* bundle, or None
        self._res_meta: Dict[str, Tuple[str, float]] = {}  # aid -> (tenant, t)
        self.lost_activations = 0  # activations lost to worker failures
        self.obs = obs
        self._tracer = None
        if obs is not None:
            self.attach_obs(obs)
        if resilience is not None:
            self.attach_resilience(resilience)

    def attach_resilience(self, resilience) -> None:
        """Attach (or, with ``None``, detach) a
        :class:`repro_torch.resilience.Resilience` bundle.  An *active* bundle
        turns on per-invoke admission (token buckets + SLO-aware shed) and
        tenant/elapsed bookkeeping for :meth:`fail_worker`'s structured
        loss records; a disabled bundle (``Resilience()``) leaves every
        hot path on its ``None`` fast branch."""
        self.resilience = resilience
        active = resilience is not None and resilience.active
        self._res = resilience if active else None
        if self.obs is not None and resilience is not None:
            resilience.register_into(self.obs.registry)

    def attach_obs(self, obs) -> None:
        """Attach (or, with ``None``, detach) an :class:`repro_torch.obs.Obs`
        bundle on a live platform: wires the tracer/timers through the
        session stack and registers every layer's counters as snapshot-time
        collectors.  Attaching after construction observes only decisions
        made from that point on."""
        self.obs = obs
        self._tracer = obs.tracer if obs is not None else None
        self.session.attach_obs(obs)
        if obs is not None:
            self._register_obs(obs)

    def _register_obs(self, obs) -> None:
        """Register every layer's counters as snapshot-time collectors in
        the obs registry — nothing here runs on the decision path."""
        reg = obs.registry
        reg.register_collector("session", lambda: dict(self.session.stats))
        reg.register_collector("platform", lambda: {
            "workers": len(self.state.workers()),
            "tags": len(self.session.tag_index),
            "lost_activations": self.lost_activations})
        if self.resilience is not None:
            self.resilience.register_into(reg)
        if self.pool is not None:
            pool = self.pool
            reg.register_collector("pool", lambda: pool.metrics.snapshot())
        if self._sharded:
            reg.register_collector("zone", lambda: self.session.zone_stats())
        if self.planner is not None and hasattr(self.planner, "stats"):
            planner = self.planner
            reg.register_collector("planner", lambda: dict(planner.stats))

    # ------------------------------------------------------------------ #
    # constructors
    # ------------------------------------------------------------------ #

    @classmethod
    def from_yaml(cls, text: str, **kwargs) -> "Platform":
        """Compile aAPP source text and stand the platform up around it."""
        if not isinstance(text, str):
            raise TypeError("from_yaml takes aAPP source text; use "
                            "from_script for an AAppScript/CompiledScript")
        return cls(text, **kwargs)

    @classmethod
    def from_script(cls, script: Union[AAppScript, CompiledScript],
                    **kwargs) -> "Platform":
        return cls(script, **kwargs)

    @classmethod
    def for_sim(cls, sim, source, **kwargs) -> "Platform":
        """A platform over a :class:`~repro_torch.cluster.simulator.ClusterSim`'s
        state / registry / pool, on the simulator's virtual clock.  The sim
        keeps ownership of time and container charging; the platform fronts
        script compilation and decisions (``platform.placer(rng)`` is the
        ``scheduler_fn`` the workload driver wants)."""
        kwargs.setdefault("pool", sim.pool)
        plat = cls(source, cluster=sim.state, registry=sim.registry,
                   clock=lambda: sim.now, **kwargs)
        if plat.obs is not None and hasattr(sim, "attach_obs"):
            sim.attach_obs(plat.obs)
        return plat

    # ------------------------------------------------------------------ #
    # registration / topology
    # ------------------------------------------------------------------ #

    @property
    def script(self) -> Optional[AAppScript]:
        return self.compiled.script if self.compiled is not None else None

    def _script_routes(self) -> bool:
        """True when the active script carries zone terms or topology hints
        — chains the sharded router must own whatever the cluster size."""
        if self.compiled is None:
            return False
        return any(b.routed for p in self.compiled.script.policies
                   for b in p.blocks)

    @property
    def diagnostics(self):
        """Compile warnings of the active script (errors raise at compile)."""
        return self.compiled.diagnostics if self.compiled is not None else ()

    def register(self, name: str, *, memory: float, tag: str) -> None:
        """Register a function: ``reg[f] = (memory, tag)`` (Listing 1)."""
        self.registry.register(name, memory=memory, tag=tag)

    def add_worker(self, name: str, *, max_memory: float,
                   zone: Optional[str] = None) -> None:
        self.state.add_worker(name, max_memory=max_memory, zone=zone)

    def zones(self) -> Tuple[str, ...]:
        return self.state.zones()

    def fail_worker(self, name: str):
        """Worker crash/drain.  Returns one structured
        :class:`~repro_torch.resilience.LostActivation` per in-flight activation
        the worker took down (function, tag, tenant, seconds in flight —
        tenant/elapsed are live with a resilience bundle attached, default
        otherwise), destroys those activations' busy containers, drains
        the worker's idle containers, and bumps the
        ``platform.lost_activations`` counter."""
        now = self.clock()
        lost = self.state.fail_worker(name)
        out = []
        track = self._res is not None
        for act in lost:
            if self.pool is not None:
                cid = self._containers.pop(act.activation_id, None)
                if cid is not None:
                    self.pool.destroy(cid)
            meta = self._res_meta.pop(act.activation_id, None) \
                if track else None
            out.append(LostActivation(
                act.activation_id, act.function, act.tag, name,
                meta[0] if meta is not None else DEFAULT_TENANT,
                now - meta[1] if meta is not None else 0.0))
        if self.pool is not None:
            self.pool.evict_worker(name)
        self.lost_activations += len(out)
        return out

    def workers(self) -> Tuple[str, ...]:
        return self.state.workers()

    # ------------------------------------------------------------------ #
    # the decision path
    # ------------------------------------------------------------------ #

    def decide(self, function: str, rng: Optional[random.Random] = None, *,
               warmth="auto", zone: Optional[str] = None) -> Decision:
        """One Listing-1 decision, *not* applied (no allocation, no
        container charge).  Simulator drivers that own allocation use this
        (or :meth:`placer`).  ``zone`` is the request's origin zone — the
        sharded router's ``local_first`` locality hint (ignored on an
        unzoned platform)."""
        tr = self._tracer
        if tr is not None:
            _t = self.clock()  # one read: nothing advances time inside
            tr.begin(_t, function, zone)
        if self._sharded:
            worker = self.session.try_schedule(
                function, rng=rng if rng is not None else self.rng,
                warmth=warmth, origin_zone=zone)
        else:
            worker = self.session.try_schedule(
                function, rng=rng if rng is not None else self.rng,
                warmth=warmth)
        if tr is not None:
            tr.decision(_t, function, worker, zone)
        return Decision(function, self.registry[function].tag, worker)

    def invoke(self, function: str, rng: Optional[random.Random] = None, *,
               warmth="auto", zone: Optional[str] = None,
               tenant: Optional[str] = None) -> Decision:
        """Decide *and apply*: allocate in the state tables (the session's
        tensors follow via the change feed) and, with a pool attached,
        acquire a container and charge its cold/warm/hot start.

        ``tenant`` stamps the request's owner for the resilience layer;
        with an active bundle attached the request first passes the
        tenant's token-bucket admission (a shed request returns an
        unplaced :class:`Decision`, counted in the bundle's shed
        counters)."""
        res = self._res
        if res is not None:
            _tn = tenant if tenant is not None else DEFAULT_TENANT
            if res.admission is not None:
                ok, _reason = res.admission.admit(
                    _tn, function, self.clock(), queue_depth=0)
                if not ok:
                    return Decision(function, self.registry[function].tag)
        tr = self._tracer
        if tr is not None:
            _t = self.clock()  # one read: nothing advances time inside
            tr.begin(_t, function, zone)
        if self._sharded:
            worker = self.session.try_schedule(
                function, rng=rng if rng is not None else self.rng,
                warmth=warmth, origin_zone=zone)
        else:
            worker = self.session.try_schedule(
                function, rng=rng if rng is not None else self.rng,
                warmth=warmth)
        if self.forecast is not None:
            self.forecast.observe(function, self.clock())
        if worker is None:
            if tr is not None:
                tr.decision(_t, function, None, zone)
            return Decision(function, self.registry[function].tag)
        act = self.state.allocate(function, worker, self.registry)
        if res is not None:
            self._res_meta[act.activation_id] = (_tn, self.clock())
        if self.pool is not None:
            c, kind, cost = self.pool.acquire(
                function, worker, self.clock(),
                memory=act.memory, tag=act.tag)
            self._containers[act.activation_id] = c.cid
            if tr is not None:
                tr.invoke(act.activation_id, _t, function, worker,
                          kind, cost, zone)
            return Decision(function, act.tag, worker,
                            activation_id=act.activation_id,
                            start_kind=kind, start_cost=cost)
        if tr is not None:
            tr.invoke(act.activation_id, _t, function, worker,
                      "none", 0.0, zone)
        return Decision(function, act.tag, worker,
                        activation_id=act.activation_id)

    def complete(self, decision_or_id: Union[Decision, str],
                 service_time: Optional[float] = None) -> Optional[Activation]:
        """Completion notification: release the container back to the pool
        and drop the activation from the tracking tables (paper §IV).
        ``service_time`` (optional) feeds the forecast estimator."""
        aid = decision_or_id
        if type(aid) is not str:
            aid = aid.activation_id
            if aid is None:
                raise ValueError(
                    "decision was never applied (no activation id)")
        if self.pool is not None:
            cid = self._containers.pop(aid, None)
            if cid is not None:
                self.pool.release(cid, self.clock())
        if self._res is not None:
            self._res_meta.pop(aid, None)
        act = self.state.complete(aid)
        if self._tracer is not None and act is not None:
            self._tracer.complete(aid, self.clock())
        if (self.forecast is not None and service_time is not None
                and act is not None):
            self.forecast.observe_service(act.function, service_time)
        return act

    def explain(self, function: str, *,
                rng: Optional[random.Random] = None,
                zone: Optional[str] = None) -> Decision:
        """Side-effect-free decision with a full explain-trace: per evaluated
        block, every considered worker's verdict (the first failing
        Listing-1 check, ``warmth-tier`` drops, or ok).  Runs the scalar
        reference path on the live conf — bit-identical semantics to the
        session (property-tested), deliberately not the hot path.  On a
        zoned platform, zone-routed tags additionally trace the router:
        ``zone-mask`` for zones a block's terms exclude, ``zone-exhausted``
        for routed zones that yielded no worker.  Does not consume the
        platform rng (``strategy: any`` draws from a private deterministic
        generator unless ``rng`` is given)."""
        if self.compiled is None:
            raise ValueError("no script loaded; reload_script() first")
        warmth_fn = None
        if self.pool is not None:
            now = self.clock()
            pool = self.pool
            warmth_fn = lambda f, w: pool.warmth(f, w, now)
        if self._sharded:
            return self.session.explain(
                function,
                rng=rng if rng is not None else random.Random(self._seed),
                warmth=warmth_fn, origin_zone=zone)
        return _explain_scalar(
            function, self.state.conf(), self.compiled.script, self.registry,
            rng=rng if rng is not None else random.Random(self._seed),
            warmth=warmth_fn)

    def placer(self, rng: Optional[random.Random] = None
               ) -> Callable[..., Optional[str]]:
        """A ``scheduler_fn`` for the workload driver / simulator: one
        decision per call, returning the worker id (or None) — the shape
        :class:`repro_torch.workload.TraceWorkload` consumes.  Accepts an optional
        ``zone=`` keyword (the arrival's origin zone) which the sharded
        router uses as its locality hint."""
        rng = rng if rng is not None else self.rng
        session = self.session
        tr = self._tracer
        if tr is not None:
            clock = self.clock

            def _traced(f, zone=None):
                tr.begin(clock(), f, zone)
                if self._sharded:
                    w = session.try_schedule(f, rng=rng, origin_zone=zone)
                else:
                    w = session.try_schedule(f, rng=rng)
                tr.decision(clock(), f, w, zone)
                return w

            # composition marker: a workload driver sharing this tracer
            # must not open a second begin/decision span per arrival
            _traced.traces_decisions = True
            return _traced
        if self._sharded:
            return lambda f, zone=None: session.try_schedule(
                f, rng=rng, origin_zone=zone)
        return lambda f, zone=None: session.try_schedule(f, rng=rng)

    def decide_batch(self, requests: Sequence[str],
                     rng: Optional[random.Random] = None, *,
                     warmth="auto", apply: bool = True,
                     zone: Optional[str] = None,
                     tenant: Optional[str] = None) -> List[Decision]:
        """Group-commit a wave of invocations through the session's fused
        bulk decide pass (:meth:`SchedulerSession.decide_wave`).

        Semantics are *exactly* a sequential loop of :meth:`invoke`
        (``apply=True``: admission, allocation, container charge, forecast
        observation — decision for decision, rng draw for rng draw) or
        :meth:`decide` (``apply=False``: nothing mutates, intra-wave
        conflicts resolved as-if-applied on a tensor scratchpad), but the
        candidate masks and strategy scores for the whole wave come from
        one [R, W] pass instead of per-item Python loops.  A batch of one
        short-circuits to the scalar path (``overhead.py --bulk`` pins
        that tax at the sub-microsecond delegation floor), and a platform
        with a tracer attached runs the
        sequential loop outright — per-decision spans are per-item control
        flow.  ``zone`` stamps every request of the wave with one origin
        zone; zone-*routed* scripts run the sequential router per item (and
        reject ``apply=False``, which would need every shard forked)."""
        if len(requests) == 1 and apply and warmth == "auto" \
                and zone is None and tenant is None and self._tracer is None:
            # lean singleton lane (no listcomp frame): the batch front end
            # must not tax callers that route every arrival through it
            return [self.invoke(requests[0],
                                rng if rng is not None else self.rng)]
        n_req = len(requests)
        if not n_req:
            return []
        rng = rng if rng is not None else self.rng
        if n_req == 1 or self._tracer is not None:
            if apply:
                return [self.invoke(f, rng, warmth=warmth, zone=zone,
                                    tenant=tenant) for f in requests]
            return [self.decide(f, rng, warmth=warmth, zone=zone)
                    for f in requests]
        fs = list(requests)
        reg = self.registry
        kw = {"origin_zone": zone} if self._sharded else {}
        if not apply:
            res = self.session.decide_wave(fs, rng=rng, warmth=warmth, **kw)
            tags: Dict[str, str] = {}
            out_s: List[Decision] = []
            for f, w in zip(fs, res.assignments):
                tg = tags.get(f)
                if tg is None:
                    tg = tags[f] = reg[f].tag
                out_s.append(Decision(f, tg, w))
            return out_s
        out: List[Optional[Decision]] = [None] * len(fs)
        res_b = self._res
        idx = list(range(len(fs)))
        if res_b is not None:
            _tn = tenant if tenant is not None else DEFAULT_TENANT
            if res_b.admission is not None:
                # admission pre-pass in arrival order: token draws are
                # placement-independent, so this equals the interleaved
                # sequential draws
                idx = []
                for i, f in enumerate(fs):
                    ok, _reason = res_b.admission.admit(
                        _tn, f, self.clock(), queue_depth=0)
                    if ok:
                        idx.append(i)
                    else:
                        out[i] = Decision(f, reg[f].tag)
                if not idx:
                    return out
        wave_fs = [fs[i] for i in idx]

        def commit(k: int, f: str, w: Optional[str]) -> None:
            # mirrors the invoke body item for item, including the
            # forecast observation of unplaced requests
            i = idx[k]
            if self.forecast is not None:
                self.forecast.observe(f, self.clock())
            if w is None:
                out[i] = Decision(f, reg[f].tag)
                return
            act = self.state.allocate(f, w, reg)
            if res_b is not None:
                self._res_meta[act.activation_id] = (_tn, self.clock())
            if self.pool is not None:
                c, kind, cost = self.pool.acquire(
                    f, w, self.clock(), memory=act.memory, tag=act.tag)
                self._containers[act.activation_id] = c.cid
                out[i] = Decision(f, act.tag, w,
                                  activation_id=act.activation_id,
                                  start_kind=kind, start_cost=cost)
            else:
                out[i] = Decision(f, act.tag, w,
                                  activation_id=act.activation_id)

        self.session.decide_wave(wave_fs, rng=rng, warmth=warmth,
                                 apply_to=self.state, commit=commit, **kw)
        return out

    def batch_placer(self, rng: Optional[random.Random] = None
                     ) -> Callable[..., List[Optional[str]]]:
        """The wave-shaped counterpart of :meth:`placer`: one call maps a
        list of function names to a list of worker ids (or ``None``s)
        through the fused bulk pass — the workload driver owns allocation,
        exactly as with :meth:`placer`.

        Without ``commit`` the wave runs on a tensor scratchpad (nothing
        mutates; intra-wave conflicts resolved as-if-applied).  With a
        ``commit(i, f, worker)`` callback the wave runs *live*: the
        callback must record each decision (allocate + container charge)
        before the next one is made — the driver's per-item dispatch body —
        which keeps pool-warmth reads mid-wave bit-identical to the
        sequential ``placer`` loop.  Shares the platform rng with
        :meth:`placer` by default, so a driver can mix both."""
        rng = rng if rng is not None else self.rng
        session = self.session

        def _place_wave(fs: Sequence[str], zone: Optional[str] = None,
                        commit=None) -> List[Optional[str]]:
            kw = {"origin_zone": zone} if self._sharded else {}
            if commit is not None:
                kw["apply_to"] = self.state
                kw["commit"] = commit
            return session.decide_wave(list(fs), rng=rng, **kw).assignments

        return _place_wave

    # ------------------------------------------------------------------ #
    # script lifecycle / time
    # ------------------------------------------------------------------ #

    def verify(self, *, budget_mb: Optional[float] = None,
               service_times=None, config=None):
        """Run the v4 static passes against the *live* cluster shape.

        Returns an :class:`repro_torch.analysis.AnalysisReport` — never raises on
        findings (errors ride on ``report.errors``), so operators can probe
        a running platform: per-tag worst-case cost rows, ``over-budget``
        checks, and the reachability verdicts (``unplaceable-chain``,
        ``budget-bound-colocation``) against the workers currently in the
        cluster.  ``budget_mb`` defaults to the attached warm pool's
        tightest per-worker keep-alive budget."""
        from repro_torch.analysis import analyze

        if self.compiled is None:
            raise AAppError("verify() needs a loaded script")
        conf = self.state.conf()
        if budget_mb is None and self.pool is not None:
            budgets = [b for b in (self.pool.budget_of(w) for w in conf)
                       if b is not None]
            if budgets:
                budget_mb = min(budgets)
        return analyze(self.compiled.script, self.registry,
                       resolved=self.compiled.resolved,
                       workers=dict(conf) if conf else None,
                       budget_mb=budget_mb, service_times=service_times,
                       config=config)

    def reload_script(self, source: Union[str, AAppScript]) -> CompiledScript:
        """Recompile and hot-swap the platform script.  Lowers into the live
        session's tag universe, so existing state tensors and unrelated row
        banks survive; decisions after the swap use the new script (and the
        v4 static passes re-run against the live cluster shape, so a script
        whose chains cannot be placed is rejected before the swap)."""
        zone_set = [z for z in self.state.zones() if z]
        conf = self.state.conf()
        compiled = compile_script(source, self.registry,
                                  tag_index=self.session.tag_index,
                                  zones=zone_set if zone_set else None,
                                  workers=dict(conf) if conf else None)
        self.compiled = compiled
        if (not self._sharded and len(zone_set) > 1
                and self._script_routes()):
            # a routed script arrived on a flat (below-shard_floor) zoned
            # platform: upgrade to the sharded plane, which the zone terms
            # need — the new flat sub-session adopts the live tag universe
            self.session.close()
            self._sharded = True
            self.session = ShardedSession(
                self.state, self.registry, compiled,
                backend=self._backend, device=self._device, pool=self.pool,
                clock=self.clock, zone_strategy=self._zone_strategy)
            if self.obs is not None:
                self.session.attach_obs(self.obs)
                self.obs.registry.register_collector(
                    "zone", lambda: self.session.zone_stats())
        else:
            self.session.set_default_script(compiled)
        if self._tracer is not None:
            self._tracer.compile_event(self.clock(), "reload",
                                       len(self.session.tag_index))
        return compiled

    def advance(self, dt: float = 0.0) -> float:
        """Advance platform time by ``dt`` (only when the platform owns its
        clock) and run the time-driven machinery at the new now: the pool
        janitor sweep, then — with a planner attached — one planning epoch
        whose prewarm/migrate/retire actions apply instantaneously (the
        cluster simulator remains the path that charges boot and transfer
        latencies).  Returns the new now."""
        if dt:
            if not self._owns_clock:
                raise ValueError("platform runs on an external clock; "
                                 "advance(dt>0) is the clock owner's job")
            self._now += dt
        now = self.clock()
        if self.pool is not None:
            self.pool.sweep(now)
            if self.planner is not None:
                for a in self.planner.plan(self.state.conf(), self.pool, now):
                    kind = type(a).__name__
                    if kind == "Prewarm":
                        self.pool.prewarm(a.function, a.worker, now,
                                          memory=a.memory, tag=a.tag)
                    elif kind == "Migrate":
                        self.pool.migrate(a.function, a.src, a.dst, now)
                    else:  # Retire
                        self.pool.retire_idle(a.function, a.worker, now)
        return now

    # ------------------------------------------------------------------ #

    def stats(self) -> Dict:
        """Operational counters: session data-plane stats + pool metrics;
        on a zoned platform, per-zone rollups (worker count, resident load,
        shard data-plane counters, idle-container residency) under
        ``"zones"``.  Shape owned by :mod:`repro_torch.obs.schema`."""
        from repro_torch.obs import schema
        return schema.platform_stats(self)

    def close(self) -> None:
        self.session.close()
