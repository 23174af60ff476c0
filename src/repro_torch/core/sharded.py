"""Zone-sharded control plane: per-zone scheduler shards + two-level routing.

One flat :class:`~repro_torch.core.batched.SchedulerSession` keeps a ``[W, T]``
occupancy tensor for the whole cluster; every decision touches all W
columns.  Zones bound that: a :class:`ShardedSession` owns one
``SchedulerSession`` per zone, each subscribed to *its zone's partition* of
the :class:`~repro_torch.core.state.ClusterState` change feed (through a
:class:`ZoneView`), so per-shard tensors stay ``W/Z``-sized and other
zones' churn never invalidates them.

Decisions route through two levels:

1. **zone selection** — per candidate block (Listing-1 block order is
   preserved), the zones admitted by the block's ``zone:``/``!zone:`` terms
   (precomputed in the compile pass's
   :class:`~repro_torch.core.compile.ZonePlan` zone-candidate mask) are ordered
   by a pluggable zone strategy — ``local_first`` (the request's origin
   zone first), ``least_loaded_zone``, ``warmest_zone`` — chosen by the
   block chain's ``topology:`` hint or the session default;
2. **in-zone decide** — the zone's shard evaluates the block against its
   own live tensors (the per-shard row banks lowered from the zone's
   filtered script), with the usual strategy/warmth rules.

**Bit-identity contract**: when a decision's chain carries no zone terms
and no topology hint, or the cluster has at most one zone, the router
*delegates to the flat session* — decisions (including rng draws) are then
bit-identical to an unsharded ``SchedulerSession``, property-tested in
``tests/test_sharded.py``.  Zone routing is therefore purely additive: a
zone-free script on a zoned cluster schedules exactly as before.

``explain`` surfaces zone-level rejections: zones excluded by a block's
terms trace as ``zone-mask``, routed zones whose shard yielded no worker
as ``zone-exhausted``.
"""
from __future__ import annotations

import random
from collections import OrderedDict
from time import perf_counter
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .ast import AAppScript
from .batched import SchedulerSession, WaveResult
from .compile import ZonePlan, zone_plan
from .decision import (
    BlockTrace,
    Decision,
    REASON_ZONE_EXHAUSTED,
    REASON_ZONE_MASK,
    WorkerVerdict,
)
from .scheduler import decide as _decide_scalar, default_rng
from .state import ClusterState, Registry
from .strategies import ZoneContext, get_zone_strategy


class ZoneView:
    """A one-zone window onto a :class:`ClusterState` — the state interface a
    :class:`SchedulerSession` reads (conf / version / change feed / active
    activations), restricted to the zone's workers and its partition of the
    feed.  Mutations still go to the real state; the view only narrows what
    a shard observes, which is what keeps shard tensors small and quiet."""

    def __init__(self, state: ClusterState, zone: str):
        self._state = state
        self.zone = zone

    # -- the SchedulerSession surface -------------------------------------- #

    def add_listener(self, fn) -> None:
        self._state.add_zone_listener(self.zone, fn)

    def remove_listener(self, fn) -> None:
        self._state.remove_zone_listener(self.zone, fn)

    @property
    def version(self) -> int:
        return self._state.zone_version(self.zone)

    def conf(self):
        return self._state.conf_zone(self.zone)

    def active_activations(self):
        zone_of = self._state.zone_of
        return tuple(a for a in self._state.active_activations()
                     if zone_of(a.worker) == self.zone)

    def workers(self) -> Tuple[str, ...]:
        zone_of = self._state.zone_of
        return tuple(w for w in self._state.workers()
                     if zone_of(w) == self.zone)


class ShardedSession:
    """Drop-in scheduling data plane over a zoned :class:`ClusterState`.

    Exposes the :class:`SchedulerSession` surface (``try_schedule`` /
    ``schedule_wave`` / ``compact`` / ``invalidate`` / ``close`` /
    ``stats`` / ``tag_index``) plus the zone-level extras
    (``origin_zone=`` routing hints, per-zone ``zone_stats`` rollups,
    zone-aware ``explain``).  The :class:`repro_torch.platform.Platform` facade
    builds one transparently whenever the cluster carries more than one
    zone.
    """

    def __init__(self, state: ClusterState, reg: Registry, script=None, *,
                 backend: str = "torch", device="cuda", pool=None,
                 clock: Optional[Callable[[], float]] = None,
                 zone_strategy: str = "local_first",
                 max_cached_scripts: int = 128):
        self.state = state
        self.reg = reg
        self.backend = backend
        self.device = device
        self.pool = pool
        self.clock = clock or (lambda: 0.0)
        self.zone_strategy = zone_strategy
        self._max_cached_scripts = max_cached_scripts
        #: the flat whole-cluster session: the delegation target for
        #: zone-free decisions and the reference the property tests pin
        self.flat = SchedulerSession(state, reg, script, backend=backend,
                                     device=device, pool=pool,
                                     clock=self.clock,
                                     max_cached_scripts=max_cached_scripts)
        self._shards: Dict[str, SchedulerSession] = {}
        self._plans: "OrderedDict[AAppScript, ZonePlan]" = OrderedDict()
        self._last_plan: Optional[Tuple[AAppScript, ZonePlan]] = None
        self._default_script: Optional[AAppScript] = None
        if script is not None:
            self._default_script = script.script \
                if hasattr(script, "ir_version") else script
        # zone_masked / zone_exhausted are the router-level rejection
        # counters: zones a block's terms excluded, and routed shard hops
        # that came back empty — the aggregate of what `explain()` traces
        # as zone-mask / zone-exhausted verdicts
        self.stats = {"decisions": 0, "delegated": 0, "routed": 0,
                      "zone_hops": 0, "zone_masked": 0, "zone_exhausted": 0,
                      "waves": 0}
        self._obs = None
        self._tracer = None
        self._timers = None

    def attach_obs(self, obs) -> None:
        """Wire an :class:`repro_torch.obs.Obs` bundle through the sharded plane:
        the router records route spans / shard_route stage times, the flat
        session and every (current and future) zone shard attach too."""
        self._obs = obs
        self._tracer = obs.tracer if obs is not None else None
        self._timers = obs.timers if obs is not None else None
        self.flat.attach_obs(obs)
        for s in self._shards.values():
            s.attach_obs(obs)

    # ------------------------------------------------------------------ #
    # lifecycle / shared-session surface
    # ------------------------------------------------------------------ #

    @property
    def tag_index(self):
        return self.flat.tag_index

    def set_default_script(self, script) -> None:
        self.flat.set_default_script(script)
        self._default_script = script.script \
            if hasattr(script, "ir_version") else script
        self._plans.clear()
        self._last_plan = None

    def invalidate(self) -> None:
        self.flat.invalidate()
        for s in self._shards.values():
            s.invalidate()

    def compact(self) -> None:
        self.flat.compact()
        for s in self._shards.values():
            s.compact()

    def close(self) -> None:
        self.flat.close()
        for s in self._shards.values():
            s.close()

    def tensors(self):
        return self.flat.tensors()

    def policies_for(self, script=None):
        return self.flat.policies_for(script)

    def zone_stats(self) -> Dict[str, Dict]:
        """Per-zone rollups: worker count, resident load, and each live
        shard's data-plane counters."""
        out: Dict[str, Dict] = {}
        for z in self.state.zones():
            row = {"workers": len(self.state.conf_zone(z)),
                   "load": self.state.zone_load(z)}
            shard = self._shards.get(z)
            if shard is not None:
                row.update({k: shard.stats[k]
                            for k in ("decisions", "deltas", "rebuilds")})
            out[z] = row
        return out

    # ------------------------------------------------------------------ #
    # plan / shard caches
    # ------------------------------------------------------------------ #

    def _shard(self, zone: str) -> SchedulerSession:
        got = self._shards.get(zone)
        if got is None:
            got = SchedulerSession(
                ZoneView(self.state, zone), self.reg, backend=self.backend,
                device=self.device, pool=self.pool, clock=self.clock,
                max_cached_scripts=self._max_cached_scripts)
            if self._obs is not None:
                got.attach_obs(self._obs)
            self._shards[zone] = got
        return got

    def _plan_for(self, script) -> ZonePlan:
        if script is None:
            script = self._default_script
            if script is None:
                raise ValueError("no script: pass one or set a session default")
        if hasattr(script, "ir_version"):
            script = script.script
        zones = self.state.zones()
        last = self._last_plan
        if last is not None and last[0] is script and last[1].zones == zones:
            return last[1]
        plan = self._plans.get(script)
        if plan is None or plan.zones != zones:
            plan = zone_plan(script, zones)
            self._plans[script] = plan
            if len(self._plans) > self._max_cached_scripts:
                self._plans.popitem(last=False)
        else:
            self._plans.move_to_end(script)
        self._last_plan = (script, plan)
        return plan

    # ------------------------------------------------------------------ #
    # the two-level decision
    # ------------------------------------------------------------------ #

    def _zone_ctx(self, f: str) -> ZoneContext:
        state = self.state
        warm_by_zone: Dict[str, int] = {}
        if self.pool is not None:
            for w, r in self.pool.warmth_row(f, self.clock()).items():
                z = state.zone_of(w)
                warm_by_zone[z] = warm_by_zone.get(z, 0) + int(r)
        return ZoneContext(load=state.zone_load,
                           warmth=lambda z: warm_by_zone.get(z, 0))

    def _zone_order(self, plan: ZonePlan, tag: str, block_index: int,
                    f: str, origin_zone: Optional[str]) -> Tuple[str, ...]:
        strat = get_zone_strategy(plan.hint(tag) or self.zone_strategy)
        if not strat.needs_ctx:  # deterministic ordering: memoised on the plan
            key = (tag, block_index, origin_zone)
            got = plan.order_cache.get(key)
            if got is not None:
                return got
        mask = plan.mask(tag)[block_index]
        cands = [z for zi, z in enumerate(plan.zones) if mask[zi]]
        if len(cands) <= 1:
            order = tuple(cands)
        else:
            ctx = self._zone_ctx(f) if strat.needs_ctx else ZoneContext.null()
            order = tuple(strat.order(cands, origin_zone, ctx))
        if not strat.needs_ctx:
            plan.order_cache[key] = order
        return order

    def try_schedule(self, f: str, *, script: Optional[AAppScript] = None,
                     rng: Optional[random.Random] = None,
                     warmth="auto",
                     origin_zone: Optional[str] = None) -> Optional[str]:
        """One decision: flat delegation for zone-free chains (bit-identical
        to :class:`SchedulerSession`), two-level routing otherwise."""
        self.stats["decisions"] += 1
        plan = self._plan_for(script)
        tag = self.reg[f].tag  # raises KeyError like the references
        if len(plan.zones) <= 1 or not plan.routed(tag):
            self.stats["delegated"] += 1
            return self.flat.try_schedule(f, script=script, rng=rng,
                                          warmth=warmth)
        self.stats["routed"] += 1
        rng = rng if rng is not None else default_rng()
        chain = plan.chain(tag)
        stats = self.stats
        tr = self._tracer
        tm = self._timers
        if tm is not None and not tm.sample():
            tm = None  # unsampled pass: route untimed
        if tm is not None:
            _t0 = perf_counter()
        masks = plan.mask(tag)
        nz = len(plan.zones)
        # route trace (tracer on only): per evaluated block the admitted
        # zones, plus every (block, zone) shard hop that came back empty
        admitted = [] if tr is not None else None
        tried: List[Tuple[int, str]] = [] if tr is not None else None
        hops0 = stats["zone_hops"]
        hint = plan.hint(tag) or self.zone_strategy
        w = None
        for bi in range(len(chain)):
            mask = masks[bi]
            stats["zone_masked"] += nz - int(mask.sum())
            if admitted is not None:
                admitted.append((bi, tuple(
                    z for zi, z in enumerate(plan.zones) if mask[zi])))
            for z in self._zone_order(plan, tag, bi, f, origin_zone):
                row = plan.pos(tag, z, bi)
                if row < 0:
                    continue
                stats["zone_hops"] += 1
                shard = self._shard(z)
                pol = shard.policies_for(plan.zone_scripts[z])
                w = shard._decide(f, pol, shard.tensors(), rng, warmth,
                                  only=(row,))
                if w is not None:
                    break
                stats["zone_exhausted"] += 1
                if tried is not None:
                    tried.append((bi, z))
            if w is not None:
                break
        if tm is not None:
            tm.observe("shard_route", perf_counter() - _t0)
        if tr is not None:
            tr.route(self.clock(), f, tag, hint, tuple(admitted),
                     tuple(tried), stats["zone_hops"] - hops0,
                     self.state.zone_of(w) if w is not None else None)
        return w

    def schedule_wave(self, fs: Sequence[str], *,
                      script: Optional[AAppScript] = None,
                      rng: Optional[random.Random] = None,
                      warmth="auto",
                      apply_to: Optional[ClusterState] = None,
                      origin_zone: Optional[str] = None) -> WaveResult:
        """Sequential wave.  Zone-free scripts delegate wholesale to the flat
        session (scratch and live modes both work there); routed waves run
        live — each decision is recorded in the state so shard tensors track
        the sequence exactly."""
        plan = self._plan_for(script)
        if len(plan.zones) <= 1 or not plan.routed_tags:
            return self.flat.schedule_wave(fs, script=script, rng=rng,
                                           warmth=warmth, apply_to=apply_to)
        if apply_to is None:
            raise ValueError(
                "a zone-routed wave must be applied (apply_to=state): "
                "scratch simulation would need every shard forked")
        if apply_to is not self.state:
            raise ValueError("apply_to must be the session's state or None")
        rng = rng if rng is not None else default_rng()
        self.stats["waves"] += 1
        assignments: List[Optional[str]] = []
        for f in fs:
            w = self.try_schedule(f, script=script, rng=rng, warmth=warmth,
                                  origin_zone=origin_zone)
            assignments.append(w)
            if w is not None:
                apply_to.allocate(f, w, self.reg)
        return WaveResult(assignments=assignments, rows_evaluated=0,
                          corrections=0)

    def decide_wave(self, fs: Sequence[str], *,
                    script: Optional[AAppScript] = None,
                    rng: Optional[random.Random] = None,
                    warmth="auto",
                    apply_to: Optional[ClusterState] = None,
                    commit: Optional[Callable[[int, str, Optional[str]],
                                              None]] = None,
                    origin_zone: Optional[str] = None) -> WaveResult:
        """Group-commit wave through the sharded plane.  Zone-free scripts
        (or single-zone clusters) delegate wholesale to the flat session's
        fused bulk pass; zone-routed waves run the sequential two-level
        router per item — routing is origin-dependent control flow the [R, W]
        pass cannot express, and the bit-identity contract only covers the
        delegated case anyway."""
        plan = self._plan_for(script)
        if len(plan.zones) <= 1 or not plan.routed_tags:
            return self.flat.decide_wave(fs, script=script, rng=rng,
                                         warmth=warmth, apply_to=apply_to,
                                         commit=commit)
        if apply_to is None:
            raise ValueError(
                "a zone-routed wave must be applied (apply_to=state): "
                "scratch simulation would need every shard forked")
        if apply_to is not self.state:
            raise ValueError("apply_to must be the session's state or None")
        rng = rng if rng is not None else default_rng()
        self.stats["waves"] += 1
        assignments: List[Optional[str]] = []
        for i, f in enumerate(fs):
            w = self.try_schedule(f, script=script, rng=rng, warmth=warmth,
                                  origin_zone=origin_zone)
            assignments.append(w)
            if commit is not None:
                commit(i, f, w)
            elif w is not None:
                apply_to.allocate(f, w, self.reg)
        return WaveResult(assignments=assignments, rows_evaluated=0,
                          corrections=0)

    # ------------------------------------------------------------------ #
    # explain (zone-level trace)
    # ------------------------------------------------------------------ #

    def explain(self, f: str, *, script: Optional[AAppScript] = None,
                rng: Optional[random.Random] = None,
                warmth=None,
                origin_zone: Optional[str] = None) -> Decision:
        """Explain-trace of the decision :meth:`try_schedule` would make.

        Zone-free chains run the scalar reference on the full conf (the flat
        explain).  Routed chains trace the router itself: per block, the
        zones excluded by the block's zone terms appear as ``zone-mask``
        verdicts, zones tried-and-exhausted as ``zone-exhausted``, and the
        winning zone's in-shard decision contributes its own scalar trace.
        Deterministic: draws come from a private seeded rng unless one is
        passed."""
        plan = self._plan_for(script)
        src = script if script is not None else self._default_script
        if hasattr(src, "ir_version"):
            src = src.script
        tag = self.reg[f].tag
        rng = rng if rng is not None else random.Random(0)
        if len(plan.zones) <= 1 or not plan.routed(tag):
            return _decide_scalar(f, self.state.conf(), src, self.reg,
                                  rng=rng, warmth=warmth, explain=True)
        chain = plan.chain(tag)
        traces: List[BlockTrace] = []
        for bi, block in enumerate(chain):
            mask = plan.mask(tag)[bi]
            verdicts: List[WorkerVerdict] = [
                WorkerVerdict(worker=f"zone:{z}", ok=False,
                              reason=REASON_ZONE_MASK)
                for zi, z in enumerate(plan.zones) if not mask[zi]]
            for z in self._zone_order(plan, tag, bi, f, origin_zone):
                row = plan.pos(tag, z, bi)
                if row < 0:
                    continue
                zscript = plan.zone_scripts[z]
                zdec = _decide_scalar(
                    f, self.state.conf_zone(z), zscript, self.reg,
                    rng=rng, warmth=warmth, explain=True)
                # only this block's verdicts matter here: the zone script's
                # chain position `row` is block `bi` in that zone
                bt = next((t for t in (zdec.trace or ()) if t.index == row),
                          None)
                if zdec.worker is not None and bt is not None \
                        and bt.selected is not None:
                    traces.append(BlockTrace(
                        index=bi, strategy=block.strategy,
                        workers=tuple(verdicts) + bt.workers,
                        selected=bt.selected))
                    return Decision(f, tag, bt.selected, block_index=bi,
                                    strategy=block.strategy,
                                    trace=tuple(traces))
                verdicts.append(WorkerVerdict(worker=f"zone:{z}", ok=False,
                                              reason=REASON_ZONE_EXHAUSTED))
            traces.append(BlockTrace(index=bi, strategy=block.strategy,
                                     workers=tuple(verdicts)))
        return Decision(f, tag, None, trace=tuple(traces))
