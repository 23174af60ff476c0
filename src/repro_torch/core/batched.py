"""Vectorized/batched aAPP scheduling — the data-plane fast path.

The scalar reference (:mod:`repro_torch.core.scheduler`) is O(blocks x workers x tags)
*per function* in Python.  At controller scale (thousands of pending
invocations x thousands of cells per wave) that loop dominates scheduling
latency, so we compile policies to tensors and evaluate Listing-1's ``valid()``
for an entire wave in one batched call:

* every (function, block) pair becomes a *row*: affinity vector ``aff[T]``
  (+1/-1/0), capacity threshold, concurrency bound, worker mask and rank;
* worker state becomes ``occ[W, T]`` tag counts + memory/concurrency vectors;
* one ``affinity_valid`` evaluation (the CUDA kernel on a GPU, its plain
  PyTorch version on the CPU) yields ``valid[R, W]`` against the wave-start
  snapshot.

Arithmetic.  ``backend="torch"`` (the default) evaluates validity and scores
in float32 through :mod:`repro_torch.kernels.affinity` on ``device``
(``"cuda"`` unless the caller asks for ``"cpu"``): its decisions equal the
JAX reference's ``backend="ref"`` decisions bit for bit, and its ``np``
decisions everywhere except where float64 rounding breaks a rational
``min_cost`` tie.  ``backend="np"`` is the explicit float64 host twin,
bit-identical to the scalar reference; it never touches the device.

Sequential exactness.  Listing 1 is inherently sequential: an allocation can
flip validity for later functions (e.g. `impera` affine to `divide` placed in
the same wave).  We preserve *exact* sequential semantics with a dirty-worker
correction pass: the snapshot matrix answers for untouched workers, and only
workers whose state changed inside the wave (typically a handful) are
re-checked scalarly.  ``schedule_wave(...)`` is therefore bit-identical to
calling :func:`repro_torch.core.scheduler.schedule` in a loop with the same RNG —
property-tested in ``tests/test_batched_equivalence.py``.

Warmth.  When a ``warmth`` callable is supplied (container-pool residency:
0 cold / 1 warm / 2 hot), a ``warm_rank[F, W]`` column is materialised at
wave start and each block's valid candidates are narrowed to the
highest-rank tier before the strategy applies — the same rule the scalar
reference implements, so equivalence (and the property test) covers it.

Incremental data plane.  :func:`schedule_wave` is one-shot: it rebuilds the
``StateTensors`` snapshot and its row tensors from scratch every call, which
at small W costs more than it saves.  :class:`SchedulerSession` is the
persistent form — tensors maintained by deltas off the
:class:`~repro_torch.core.state.ClusterState` change feed, per-tag row banks cached
across waves, decisions evaluated against the *live* tensors (no snapshot
corrections), warmth read from the pool's sparse residency index.  It is the
production path: ``serve.Engine`` and the simulator workloads schedule
through it.  Same bit-exact contract, property-tested in
``tests/test_session_property.py``.
"""
from __future__ import annotations

import dataclasses
import math
import random
from collections import OrderedDict
from time import perf_counter
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .ast import (
    AAppScript,
    Block,
    STRATEGY_ANY,
    STRATEGY_BEST_FIRST,
)
from .decision import REASON_UNKNOWN_WORKER, REASON_WARMTH_TIER
from .scheduler import Warmth, candidate_blocks, default_rng, rejection_reason
from .state import ClusterState, Conf, Registry
from .strategies import (BestFirst, LeastLoaded, MinCost, SelectionContext,
                         Warmest, get_strategy)
from repro_torch.kernels.affinity import (NO_CAP, NO_CONC, affinity_valid_np,
                                          bulk_argmin_np, bulk_decide_np,
                                          bulk_scores_np, resolve_device)
from repro_torch.kernels.affinity.bulk_np import (CONGESTION_S as _BULK_CONGESTION,
                                            LIFECYCLE_S as _BULK_LIFECYCLE,
                                            WARMEST_BASE as _WARMEST_BASE)

# Built-in strategies the fused bulk decide pass can express as a score row +
# argmin (codes match repro.kernels.affinity.bulk_np.STRATEGY_CODES).  The
# map is keyed by *class* so a user strategy registered over one of these
# names falls back to the exact per-item reference path.
_VEC_STRATEGIES = {BestFirst: 0, LeastLoaded: 1, Warmest: 2, MinCost: 3}
_WARMEST_BASE32 = 4194304.0  # 2**22: f32-exact packing (mirrors bulk_ref)
_MIN_COST_LIFE20 = tuple(c / _BULK_CONGESTION for c in _BULK_LIFECYCLE)
_MIN_COST_CLAMP32 = 16777216.0 - 16.0  # 2**24 - 16 (mirrors bulk_ref)
_F32_NEG_INF = np.float32(-np.inf)
_F32_POS_INF = np.float32(np.inf)


def _round32_le_cut(t: np.float32) -> float:
    """Float64 cutoff ``c`` with ``mem < c  <=>  float32(mem) <= t`` for any
    non-NaN float64 ``mem`` — folds the float32 round *and* the compare into
    one exact python-float strict compare.  The boundary is the round-to-
    nearest-even midpoint between ``t`` and the next float32 up (exact in
    f64: adjacent f32 values sum without rounding); when the tie itself
    rounds down to ``t`` the midpoint passes, which a strict compare
    expresses by stepping the cutoff one f64 ulp higher."""
    if np.isinf(t):
        return float(t)  # +inf: everything finite passes; -inf: nothing
    nxt = np.nextafter(t, _F32_POS_INF, dtype=np.float32)
    if np.isinf(nxt):
        # t is the largest finite f32: values at/above the overflow
        # midpoint round to +inf (the tie rounds to the even 2**128)
        return float(t) + 2.0 ** 103
    mid = (float(t) + float(nxt)) / 2.0
    if np.float32(mid) == t:  # tie rounds down: mem == mid still passes
        return math.nextafter(mid, math.inf)
    return mid


def _f32_cell_cut(f_mem32: np.float32, cap32: np.float32, max_mem) -> float:
    """Precomputed per-(row, worker) validity cutoff: the float64 ``cut``
    such that, for the row's f32 arithmetic on this worker,

      ``mem_used < cut``  <=>  ``f32(mem_used) + f_mem32 <= f32(max_mem)``
                               and ``f32(mem_used) < cap32 * f32(max_mem)``

    so the hot per-commit recheck is ONE exact python-float compare instead
    of a chain of numpy float32 scalar ops.  The capacity-fit term uses
    float32-add monotonicity: the largest f32 ``x`` with
    ``f32(x + f_mem32) <= M`` bounds ``f32(mem_used)`` exactly, including
    at rounding boundaries where the sum lands exactly on ``M``."""
    M = np.float32(max_mem)
    x = np.float32(M - f_mem32)
    if np.float32(x + f_mem32) <= M:
        up = np.nextafter(x, _F32_POS_INF, dtype=np.float32)
        while np.float32(up + f_mem32) <= M:
            x = up
            up = np.nextafter(up, _F32_POS_INF, dtype=np.float32)
    else:
        while not (np.float32(x + f_mem32) <= M) and x != _F32_NEG_INF:
            x = np.nextafter(x, _F32_NEG_INF, dtype=np.float32)
    mem_cut = _round32_le_cut(x)
    # strict `f32(mem) < capthr`  ==  `f32(mem) <= prev32(capthr)`
    cap_cut = _round32_le_cut(
        np.nextafter(cap32 * M, _F32_NEG_INF, dtype=np.float32))
    return mem_cut if mem_cut < cap_cut else cap_cut
BULK_BATCH_BOUNDS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                     256.0, 512.0, 1024.0, 2048.0, 4096.0)


# --------------------------------------------------------------------------- #
# tag universe
# --------------------------------------------------------------------------- #


class TagIndex:
    """Append-only tag -> column map.  ``ensure`` grows the universe in place
    (existing columns never move), which is what lets a long-lived
    :class:`SchedulerSession` absorb dynamically registered tags — session
    KV tags, ``warm:<fn>`` residency tags — without recompiling old rows:
    an old affinity vector is still exact after zero-padding to the new T."""

    def __init__(self, tags: Sequence[str]):
        self.tags: Tuple[str, ...] = tuple(dict.fromkeys(tags))
        self.index: Dict[str, int] = {t: i for i, t in enumerate(self.tags)}

    @staticmethod
    def from_script(script: AAppScript, reg: Registry) -> "TagIndex":
        tags = list(script.tags) + list(reg.tags())
        for _, refs in script.referenced_tags().items():
            tags.extend(refs)
        return TagIndex(tags)

    def ensure(self, tag: str) -> int:
        """Column of ``tag``, appending a fresh one if unknown."""
        got = self.index.get(tag)
        if got is None:
            got = len(self.tags)
            self.tags = self.tags + (tag,)
            self.index[tag] = got
        return got

    def ensure_script(self, script: AAppScript, reg: Registry) -> None:
        """Ensure every tag the script can *read*: its policy tags and its
        blocks' affinity terms.  Registry tags are deliberately not swept in
        (unlike :meth:`from_script`) — a tag no script references is never
        consulted by ``valid()``, and long-lived registries accumulate dead
        per-session tags that would defeat :meth:`SchedulerSession.compact`;
        resident tags enter the universe via allocation deltas instead."""
        for t in script.tags:
            self.ensure(t)
        for _, refs in script.referenced_tags().items():
            for t in refs:
                self.ensure(t)

    def __len__(self) -> int:
        return len(self.tags)

    def __getitem__(self, tag: str) -> int:
        return self.index[tag]


# --------------------------------------------------------------------------- #
# compiled policies
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class CompiledBlock:
    aff: np.ndarray  # [T] int8
    cap_pct: float
    max_conc: int
    strategy: str
    wildcard: bool
    worker_ids: Tuple[str, ...]  # explicit list (order = rank) if not wildcard
    block: Block  # original (for scalar re-checks)
    zones: Tuple[str, ...] = ()  # v2 zone terms: required worker zones
    anti_zones: Tuple[str, ...] = ()  # excluded worker zones

    def admits_zone(self, zone: str) -> bool:
        if self.zones and zone not in self.zones:
            return False
        return zone not in self.anti_zones


@dataclasses.dataclass
class TagRows:
    """Stacked row tensors for one tag's candidate block list — the unit the
    session caches across waves.  ``aff`` is zero-padded in place when the
    shared tag universe grows (appended columns can't be referenced by an
    already-compiled block, so padding is exact)."""

    cbs: List[CompiledBlock]
    aff: np.ndarray  # [B, T] int8
    cap: np.ndarray  # [B] f64
    conc: np.ndarray  # [B] i32
    pos: np.ndarray = None  # [B, T] f32 (aff == 1), kept in sync with aff
    neg: np.ndarray = None  # [B, T] f32 (aff == -1)
    cap_rows: np.ndarray = None  # [k] row indices with a capacity_used rule
    conc_rows: np.ndarray = None  # [k] row indices with a concurrency rule
    # worker-mask cache, stamped with the session's worker epoch; living on
    # the bank (not in a session-side id()-keyed dict) it is evicted together
    # with its CompiledPolicies and can never alias a recycled object id
    wmask: Optional[np.ndarray] = None
    wmask_epoch: int = -1

    def __post_init__(self):
        self._derive()

    def _derive(self) -> None:
        self.pos = (self.aff == 1).astype(np.float32)
        self.neg = (self.aff == -1).astype(np.float32)
        self.cap_rows = np.flatnonzero(self.cap < NO_CAP)
        self.conc_rows = np.flatnonzero(self.conc < NO_CONC)

    def aff_at(self, T: int) -> np.ndarray:
        if self.aff.shape[1] < T:
            pad = np.zeros((self.aff.shape[0], T - self.aff.shape[1]), np.int8)
            self.aff = np.concatenate([self.aff, pad], axis=1)
            self._derive()
        return self.aff


class CompiledPolicies:
    """tag -> compiled candidate block list (with followup/defaults resolved)."""

    def __init__(self, script: AAppScript, reg: Registry, tag_index: Optional[TagIndex] = None):
        self.script = script
        self.tag_index = tag_index or TagIndex.from_script(script, reg)
        self._cache: Dict[str, List[CompiledBlock]] = {}
        self._rows: Dict[str, TagRows] = {}

    def blocks_for(self, tag: str) -> List[CompiledBlock]:
        got = self._cache.get(tag)
        if got is None:
            got = [self._compile(b) for b in candidate_blocks(tag, self.script)]
            self._cache[tag] = got
        return got

    def rows_for(self, tag: str) -> TagRows:
        """Cached stacked rows for ``tag`` (compiled once per session)."""
        bank = self._rows.get(tag)
        if bank is None:
            cbs = self.blocks_for(tag)
            T = len(self.tag_index)
            if cbs:
                aff = np.stack([cb.aff for cb in cbs]).astype(np.int8)
            else:
                aff = np.zeros((0, T), np.int8)
            cap = np.array([cb.cap_pct for cb in cbs], np.float64)
            conc = (np.array([cb.max_conc for cb in cbs], np.int64)
                    .clip(max=NO_CONC).astype(np.int32))
            bank = TagRows(cbs=cbs, aff=aff, cap=cap, conc=conc)
            self._rows[tag] = bank
        return bank

    def _compile(self, block: Block) -> CompiledBlock:
        T = len(self.tag_index)
        aff = np.zeros((T,), np.int8)
        for t in block.affinity.affine:
            aff[self.tag_index[t]] = 1
        for t in block.affinity.anti_affine:
            aff[self.tag_index[t]] = -1
        inv = block.invalidate
        return CompiledBlock(
            aff=aff,
            cap_pct=float(inv.capacity_used) if inv.capacity_used is not None else NO_CAP,
            max_conc=int(inv.max_concurrent_invocations)
            if inv.max_concurrent_invocations is not None
            else NO_CONC,
            strategy=block.strategy,
            wildcard=block.is_wildcard,
            worker_ids=() if block.is_wildcard else block.workers,
            block=block,
            zones=block.affinity.zones,
            anti_zones=block.affinity.anti_zones,
        )


# --------------------------------------------------------------------------- #
# state snapshot tensors
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class StateTensors:
    """Worker-state snapshot tensors, maintainable by O(1)-ish deltas.

    ``from_conf`` builds a fresh snapshot; the ``apply_*`` methods replay the
    :class:`repro_torch.core.state.ClusterState` change feed onto an existing one so
    a :class:`SchedulerSession` never rebuilds per wave.  Delta exactness:
    ``occ``/``n_funcs`` are integer counters; ``mem_used`` is *recomputed*
    from the per-worker resident-memory table (``_res_mem``, insertion order
    mirroring ``activeFunctions``) on every touch, so after any interleaving
    of deltas the tensors are bit-identical to ``from_conf`` of the final
    conf — property-tested in ``tests/test_session_property.py``.
    """

    workers: Tuple[str, ...]  # conf order
    widx: Dict[str, int]
    occ: np.ndarray  # [W, T] int32
    mem_used: np.ndarray  # [W] f64 (the scalar reference sums python floats)
    max_mem: np.ndarray  # [W] f64
    n_funcs: np.ndarray  # [W] i32
    zones: Tuple[str, ...] = ()  # worker zones, parallel to ``workers``
    # worker -> ordered {activation key: memory}; insertion order mirrors the
    # state's activeFunctions table so the float64 sum matches from_conf's.
    _res_mem: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    # bumped on every mutation — consumers key derived caches off it
    rev: int = 0

    @staticmethod
    def from_conf(conf: Conf, tag_index: TagIndex) -> "StateTensors":
        workers = tuple(conf.keys())
        W, T = len(workers), len(tag_index)
        occ = np.zeros((W, T), np.int32)
        mem_used = np.zeros((W,), np.float64)
        max_mem = np.zeros((W,), np.float64)
        n_funcs = np.zeros((W,), np.int32)
        res_mem: Dict[str, Dict[str, float]] = {}
        for i, w in enumerate(workers):
            view = conf[w]
            mem_used[i] = view.memory_used
            max_mem[i] = view.max_memory
            n_funcs[i] = len(view.fs)
            for t in view.tags:
                j = tag_index.index.get(t)
                if j is not None:
                    occ[i, j] += 1
            # the conf view has no per-activation memories: a from_conf
            # snapshot starts with an empty resident table and only supports
            # deltas whose keys it has itself seen (use from_state otherwise)
            res_mem[w] = {}
        return StateTensors(
            workers=workers,
            widx={w: i for i, w in enumerate(workers)},
            occ=occ,
            mem_used=mem_used,
            max_mem=max_mem,
            n_funcs=n_funcs,
            zones=tuple(conf[w].zone for w in workers),
            _res_mem=res_mem,
        )

    @staticmethod
    def from_state(state: ClusterState, tag_index: TagIndex) -> "StateTensors":
        """Snapshot with real activation keys in the resident-memory table,
        so subsequent ``complete`` deltas can find their entries.  Resident
        tags unknown to ``tag_index`` are ensured first (appended columns),
        keeping the occupancy matrix complete for any future script."""
        acts = state.active_activations()
        for a in acts:
            if a.tag:
                tag_index.ensure(a.tag)
        snap = StateTensors.from_conf(state.conf(), tag_index)
        for a in acts:  # global allocation order == per-worker insertion order
            snap._res_mem.setdefault(a.worker, {})[a.activation_id] = a.memory
        return snap

    # ---- deltas (the ClusterState change feed, replayed) ------------------- #

    def ensure_tags(self, T: int) -> None:
        """Grow the occupancy matrix to ``T`` tag columns (appended zeros)."""
        cur = self.occ.shape[1]
        if T > cur:
            self.occ = np.concatenate(
                [self.occ, np.zeros((len(self.workers), T - cur), np.int32)],
                axis=1)
            self.rev += 1

    def _recompute_mem(self, i: int, worker: str) -> None:
        # float64 sum in residency insertion order == the scalar reference's
        # ``view.memory_used`` (a python-float sum in the same order)
        self.mem_used[i] = sum(self._res_mem.get(worker, {}).values())

    def apply_alloc(self, worker: str, tag: str, memory: float, key: str,
                    tag_index: TagIndex) -> None:
        i = self.widx[worker]
        if tag:
            col = tag_index.ensure(tag)
            self.ensure_tags(len(tag_index))
            self.occ[i, col] += 1
        self._res_mem.setdefault(worker, {})[key] = float(memory)
        self._recompute_mem(i, worker)
        self.n_funcs[i] += 1
        self.rev += 1

    def apply_release(self, worker: str, tag: str, memory: float, key: str,
                      tag_index: TagIndex) -> None:
        i = self.widx.get(worker)
        if i is None:
            return  # worker already dropped
        if tag:
            col = tag_index.index.get(tag)
            if col is not None and col < self.occ.shape[1]:
                self.occ[i, col] -= 1
        self._res_mem.get(worker, {}).pop(key, None)
        self._recompute_mem(i, worker)
        self.n_funcs[i] -= 1
        self.rev += 1

    def apply_add_worker(self, worker: str, max_memory: float,
                         zone: str = "") -> None:
        i = len(self.workers)
        self.workers = self.workers + (worker,)
        self.widx[worker] = i
        self.occ = np.concatenate(
            [self.occ, np.zeros((1, self.occ.shape[1]), np.int32)], axis=0)
        self.mem_used = np.append(self.mem_used, 0.0)
        self.max_mem = np.append(self.max_mem, float(max_memory))
        self.n_funcs = np.append(self.n_funcs, np.int32(0)).astype(np.int32)
        self.zones = self.zones + (zone,)
        self._res_mem[worker] = {}
        self.rev += 1

    def apply_drop_worker(self, worker: str) -> None:
        i = self.widx.get(worker)
        if i is None:
            return
        self.workers = self.workers[:i] + self.workers[i + 1:]
        self.widx = {w: j for j, w in enumerate(self.workers)}
        self.occ = np.delete(self.occ, i, axis=0)
        self.mem_used = np.delete(self.mem_used, i)
        self.max_mem = np.delete(self.max_mem, i)
        self.n_funcs = np.delete(self.n_funcs, i)
        self.zones = self.zones[:i] + self.zones[i + 1:]
        self._res_mem.pop(worker, None)
        self.rev += 1

    def copy(self) -> "StateTensors":
        return StateTensors(
            workers=self.workers,
            widx=dict(self.widx),
            occ=self.occ.copy(),
            mem_used=self.mem_used.copy(),
            max_mem=self.max_mem.copy(),
            n_funcs=self.n_funcs.copy(),
            zones=self.zones,
            _res_mem={w: dict(d) for w, d in self._res_mem.items()},
            rev=self.rev,
        )

    def scratch_copy(self) -> "StateTensors":
        """Copy for as-if-applied scratch waves: shares every structure a
        scratch commit never mutates (worker roster, ``widx``, zones,
        ``max_mem`` and the resident-memory table — scratch applies bump the
        sum arrays directly and never release), so the per-wave cost is
        three array copies instead of a worker-count-sized dict walk."""
        return StateTensors(
            workers=self.workers,
            widx=self.widx,
            occ=self.occ.copy(),
            mem_used=self.mem_used.copy(),
            max_mem=self.max_mem,
            n_funcs=self.n_funcs.copy(),
            zones=self.zones,
            _res_mem=self._res_mem,
            rev=self.rev,
        )

    def equals(self, other: "StateTensors") -> bool:
        """Bit-exact equality of the scheduling-visible tensors (the resident
        memory bookkeeping table is excluded: synthetic vs real keys)."""
        if self.workers != other.workers:
            return False
        T = max(self.occ.shape[1], other.occ.shape[1])

        def pad(occ: np.ndarray) -> np.ndarray:
            if occ.shape[1] == T:
                return occ
            return np.concatenate(
                [occ, np.zeros((occ.shape[0], T - occ.shape[1]), np.int32)], axis=1)

        return (self.zones == other.zones
                and np.array_equal(pad(self.occ), pad(other.occ))
                and np.array_equal(self.mem_used, other.mem_used)
                and np.array_equal(self.max_mem, other.max_mem)
                and np.array_equal(self.n_funcs, other.n_funcs))


# --------------------------------------------------------------------------- #
# wave scheduler
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class WaveResult:
    assignments: List[Optional[str]]  # per function, worker id or None
    rows_evaluated: int
    corrections: int


class _WaveRow:
    """One (function, block) row of an in-flight decide_wave: the writable
    score vector, the cached first-minimum winner, and the deferred-staleness
    set that makes per-commit maintenance O(dirty workers) instead of O(W)."""

    __slots__ = ("cb", "wm", "wm_mv", "code", "score", "winner", "wscore",
                 "stale", "pos_list", "neg_list", "pos_cols", "seq", "cap32",
                 "cap64", "maxc", "has_cap", "has_conc", "thr")

    def __init__(self, cb: CompiledBlock, wm: np.ndarray, code: int,
                 score: np.ndarray, winner: int, wscore: float):
        self.cb = cb
        self.wm = wm  # static worker mask row (zones + wildcard)
        try:  # buffer view: python-bool reads without numpy scalar boxing
            self.wm_mv = memoryview(wm)
        except (TypeError, ValueError):  # non-exportable (e.g. broadcast)
            self.wm_mv = wm
        self.code = code  # bulk strategy code
        self.score = score  # [W] f64 (np backend) / f32 (torch)
        self.winner = winner  # cached first-min index, -1 when none
        self.wscore = wscore
        self.stale: set = set()  # workers whose score entry is deferred
        # per-ROW event-log cursor: a pick returns at the first winning row,
        # so rows below it fold the skipped events in whenever next reached
        self.seq = 0
        self.pos_list = np.flatnonzero(cb.aff == 1).tolist()
        self.neg_list = np.flatnonzero(cb.aff == -1).tolist()
        # placements of these tag columns can *revive* an invalid worker
        self.pos_cols = frozenset(self.pos_list)
        # capacity fractions hoisted out of the per-cell recheck, keeping the
        # wave-start operation order: f32 (cap * 0.01f) * maxm, f64
        # (cap / 100.0) * maxm
        self.cap32 = np.float32(cb.cap_pct) * np.float32(0.01)
        self.cap64 = cb.cap_pct / 100.0
        self.maxc = int(cb.max_conc)  # python int: cheap hot-path compare
        self.has_cap = cb.cap_pct < NO_CAP
        self.has_conc = cb.max_conc < NO_CONC
        self.thr: Dict[int, float] = {}  # per-worker f32 validity cutoffs


class _WaveFn:
    """Per-unique-function wave state: its rows plus the warmth vector the
    scores were built from (mutable so live pool acquires can be folded in)."""

    __slots__ = ("f", "tag", "f_mem", "f_mem32", "rows", "warm", "warm_mv",
                 "col")

    def __init__(self, f: str, tag: str, f_mem: float,
                 rows: List[_WaveRow], warm: Optional[np.ndarray]):
        self.f = f
        self.tag = tag
        self.f_mem = f_mem
        self.f_mem32 = np.float32(f_mem)
        self.rows = rows
        self.warm = warm  # [W] i32 ranks or None (rank 0 everywhere)
        # buffer view: python-int rank reads without numpy scalar boxing
        # (live pool writes go through self.warm and stay visible)
        self.warm_mv = None if warm is None else memoryview(warm)
        self.col = -2  # scratch tag column, resolved lazily (-2 = unresolved)


def _row_valid_scalar(
    cb: CompiledBlock,
    f_mem: float,
    occ_row: np.ndarray,
    mem_used: float,
    max_mem: float,
    n_funcs: int,
    zone: str = "",
) -> bool:
    """Scalar re-check of one (function-block, worker) cell on live state."""
    if not cb.admits_zone(zone):
        return False
    if mem_used + f_mem > max_mem:
        return False
    if cb.cap_pct < NO_CAP and mem_used >= cb.cap_pct * 0.01 * max_mem:
        return False
    if cb.max_conc < NO_CONC and n_funcs >= cb.max_conc:
        return False
    pos = cb.aff == 1
    if pos.any() and (occ_row[pos] == 0).any():
        return False
    neg = cb.aff == -1
    if neg.any() and (occ_row[neg] > 0).any():
        return False
    return True


def schedule_wave(
    fs: Sequence[str],
    conf: Conf,
    policies: CompiledPolicies,
    reg: Registry,
    *,
    rng: Optional[random.Random] = None,
    backend: str = "torch",
    device="cuda",
    apply_to: Optional[ClusterState] = None,
    warmth: Optional[Warmth] = None,
) -> WaveResult:
    """Schedule ``fs`` in order with exact Listing-1 semantics.

    One batched ``valid`` evaluation against the wave-start snapshot + scalar
    corrections for workers dirtied by earlier assignments in the same wave.
    """
    rng = rng if rng is not None else default_rng()
    tag_index = policies.tag_index
    snap = StateTensors.from_conf(conf, tag_index)
    W = len(snap.workers)
    # warmth-rank column: container-pool residency per (function, worker)
    warm_rank: Optional[np.ndarray] = None
    if warmth is not None and W:
        warm_rank = np.array(
            [[warmth(f, w) for w in snap.workers] for f in fs], np.int32
        )  # [F, W]

    # ---- build rows -------------------------------------------------------- #
    rows: List[Tuple[int, CompiledBlock]] = []  # (function position, block)
    row_of: List[List[int]] = []  # function position -> row ids (block order)
    f_mems: List[float] = []
    f_tags: List[str] = []
    for fi, f in enumerate(fs):
        spec = reg[f]
        f_mems.append(spec.memory)
        f_tags.append(spec.tag)
        ids = []
        for cb in policies.blocks_for(spec.tag):
            ids.append(len(rows))
            rows.append((fi, cb))
        row_of.append(ids)

    R = len(rows)
    if R == 0 or W == 0:
        return WaveResult(assignments=[None] * len(fs), rows_evaluated=0, corrections=0)

    aff = np.stack([cb.aff for _, cb in rows])  # [R, T]
    cap = np.array([cb.cap_pct for _, cb in rows], np.float32)
    conc = np.array([cb.max_conc for _, cb in rows], np.int64).clip(max=NO_CONC).astype(np.int32)
    f_mem_rows = np.array([f_mems[fi] for fi, _ in rows], np.float32)
    wmask = np.zeros((R, W), bool)
    for r, (fi, cb) in enumerate(rows):
        if cb.wildcard:
            wmask[r, :] = True
        else:
            for wid in cb.worker_ids:
                j = snap.widx.get(wid)
                if j is not None:
                    wmask[r, j] = True
        if cb.zones or cb.anti_zones:  # v2 zone terms: candidacy mask
            for j, z in enumerate(snap.zones):
                if not cb.admits_zone(z):
                    wmask[r, j] = False

    valid = affinity_valid_np(
        snap.occ,
        aff,
        wmask,
        snap.mem_used,
        snap.max_mem,
        snap.n_funcs,
        f_mem_rows,
        cap,
        conc,
        backend=backend,
        device=device,
    )  # [R, W] bool

    # ---- sequential pass with dirty corrections ----------------------------- #
    live_occ = snap.occ  # copy-on-dirty
    live_mem = snap.mem_used
    live_nfn = snap.n_funcs
    dirtied = False
    dirty: set = set()
    corrections = 0
    tag_col: Dict[str, int] = tag_index.index

    assignments: List[Optional[str]] = []
    for fi, f in enumerate(fs):
        chosen: Optional[str] = None
        for r in row_of[fi]:
            cb = rows[r][1]
            strat = get_strategy(cb.strategy)
            # candidate order must match the reference: explicit list order,
            # or conf order for wildcard blocks.
            if cb.wildcard:
                order = range(W)
            else:
                order = [snap.widx[w] for w in cb.worker_ids if w in snap.widx]
            candidates: List[int] = []
            for j in order:
                if j in dirty:
                    corrections += 1
                    ok = _row_valid_scalar(
                        cb,
                        f_mems[fi],
                        live_occ[j],
                        float(live_mem[j]),
                        float(snap.max_mem[j]),
                        int(live_nfn[j]),
                        snap.zones[j],
                    )
                else:
                    ok = bool(valid[r, j])
                if ok:
                    # best_first can stop at the first valid worker — with a
                    # warmth column only once the top (hot = 2) tier is hit,
                    # since no later worker can outrank it
                    if strat.first_valid_wins and (
                            warm_rank is None or warm_rank[fi, j] >= 2):
                        candidates = [j]
                        break
                    candidates.append(j)
            if candidates:
                if warm_rank is not None and strat.narrow_warmth:
                    # narrow to the warmest tier (same rule as the scalar ref)
                    best_rank = max(int(warm_rank[fi, j]) for j in candidates)
                    candidates = [j for j in candidates
                                  if int(warm_rank[fi, j]) == best_rank]
                ctx = SelectionContext(
                    load=lambda j: int(live_nfn[j]),
                    warmth=(lambda j: int(warm_rank[fi, j]))
                    if warm_rank is not None else (lambda j: 0))
                jj = strat.select(candidates, ctx, rng)
                chosen = snap.workers[jj]
                if not dirtied:
                    live_occ = live_occ.copy()
                    live_mem = live_mem.copy()
                    live_nfn = live_nfn.copy()
                    dirtied = True
                col = tag_col.get(f_tags[fi])
                if col is not None:
                    live_occ[jj, col] += 1
                live_mem[jj] += f_mems[fi]
                live_nfn[jj] += 1
                dirty.add(jj)
                break
        assignments.append(chosen)
        if apply_to is not None and chosen is not None:
            apply_to.allocate(f, chosen, reg)

    return WaveResult(assignments=assignments, rows_evaluated=R, corrections=corrections)


# --------------------------------------------------------------------------- #
# persistent scheduling session (the incremental data plane)
# --------------------------------------------------------------------------- #


class SchedulerSession:
    """Persistent scheduling data plane over one :class:`ClusterState`.

    The per-wave cost profile of :func:`schedule_wave` is dominated by work
    that doesn't change between waves: ``StateTensors.from_conf`` rebuilds,
    per-function row compilation, and — at small W — the scalar
    dirty-correction pass.  A session keeps all of it warm:

    * **state tensors by delta** — the session subscribes to the state's
      change feed and replays allocate/complete/add-worker/fail-worker as
      O(1)-ish tensor deltas (``StateTensors.apply_*``); no rebuild per wave.
      Safety net: every decision cross-checks ``state.version`` against the
      last delta seen, and any mismatch (or an explicit :meth:`invalidate`)
      falls back to a fresh ``from_state`` snapshot — correctness never
      depends on the feed being complete;
    * **compiled rows per tag** — ``CompiledPolicies.rows_for`` banks are
      compiled once per (script, tag) and padded in place as the shared
      append-only :class:`TagIndex` grows.  Scripts are hashable (frozen
      dataclasses), so dynamically synthesised per-request scripts (e.g.
      ``serve.Engine``'s) hit an LRU of compiled policies;
    * **vectorised decisions on live tensors** — each decision evaluates the
      tag's whole block bank against the *current* tensors in one batched
      ``valid`` call (pure-numpy backend by default: no device dispatch on
      the CPU hot path) and then applies Listing-1's block order / strategy /
      warmth-tier rules exactly.  Because the tensors are live, sequential
      exactness needs no snapshot-correction pass — a wave is just the
      decision loop with deltas applied between picks, bit-identical to the
      scalar reference (property-tested in ``tests/test_batched_equivalence``
      and ``tests/test_session_property``);
    * **vectorised warmth** — with a warm pool attached, the warmth column
      comes from the pool's sparse idle-residency table
      (:meth:`repro_torch.pool.WarmPool.warmth_row`, O(#idle keys) per decision)
      instead of F x W Python ``warmth()`` calls.

    ``warmth`` arguments accept ``"auto"`` (pool-backed ranks when a pool is
    attached, else none), ``None`` (off), or an explicit
    ``(function, worker) -> rank`` callable.

    ``backend="torch"`` (the default) runs the batched ``valid`` matrix and
    the fused bulk pass in float32 on ``device`` — the CUDA kernels on
    ``"cuda"`` (the default; raises when no card is present), their plain
    PyTorch versions on ``"cpu"``.  Its decisions equal the JAX reference's
    ``backend="ref"`` bit for bit, and the float64 ``np`` decisions except
    where float64 rounding breaks a rational ``min_cost`` tie.  The state
    tensors stay numpy on the host: each decision copies them to the device.
    ``backend="np"`` is the explicit float64 host twin.
    """

    def __init__(self, state: ClusterState, reg: Registry,
                 script=None, *,
                 backend: str = "torch", device="cuda", pool=None,
                 clock: Optional[Callable[[], float]] = None,
                 max_cached_scripts: int = 128):
        if backend not in ("torch", "np"):
            raise ValueError(f"unknown backend {backend!r}: 'torch' (float32 "
                             "on the device) or 'np' (float64 host twin)")
        self.state = state
        self.reg = reg
        self.backend = backend
        # the np twin never touches the device; the torch path raises here,
        # not at the first decision, when the card it asks for is absent
        self.device = (resolve_device(device) if backend == "torch"
                       else device)
        self.pool = pool
        self.clock = clock or (lambda: 0.0)
        self.tag_index = TagIndex([])
        self._default_script: Optional[AAppScript] = None
        self._policies: "OrderedDict[AAppScript, CompiledPolicies]" = OrderedDict()
        self._max_cached_scripts = max_cached_scripts
        self._snap: Optional[StateTensors] = None
        self._synced_version = -1
        self._worker_epoch = 0
        # (occ array ref, rev, emptyT, presentT): the strong reference makes
        # the identity check sound (a live key can't be a recycled address)
        self._occ_cache = None
        self._last_pol: Optional[Tuple[AAppScript, CompiledPolicies]] = None
        self.stats = {"decisions": 0, "deltas": 0, "rebuilds": 0, "waves": 0,
                      "bulk_waves": 0, "bulk_fallback": 0}
        # in-flight decide_wave bookkeeping: the change-feed handler appends
        # every event here while a wave is open so the wave can tell its own
        # group-commit allocations from structural changes (compact() bumps
        # the counter for the same reason — a mid-wave compact rebuilds the
        # tag universe, so in-flight tag-row indices must be re-derived)
        self._wave_watch: Optional[List[Tuple[str, Dict]]] = None
        self._compactions = 0
        # observability plane (repro_torch.obs): None until attached — the hot
        # paths guard with a single `is not None`, so a session without obs
        # pays nothing (the `overhead.py --obs` disabled-path gate)
        self._tracer = None
        self._timers = None
        state.add_listener(self._on_event)
        if script is not None:  # AAppScript or compile.CompiledScript
            self.set_default_script(script)

    def attach_obs(self, obs) -> None:
        """Wire an :class:`repro_torch.obs.Obs` bundle into the session: decision
        tracing (``obs.tracer``) and hot-path stage timers (``obs.timers``).
        Pass ``None`` to detach."""
        self._tracer = obs.tracer if obs is not None else None
        self._timers = obs.timers if obs is not None else None

    def close(self) -> None:
        """Detach from the state's change feed."""
        self.state.remove_listener(self._on_event)

    # ---- tensor maintenance ------------------------------------------------ #

    def invalidate(self) -> None:
        """Drop the cached tensors; the next decision rebuilds from state."""
        self._snap = None

    def compact(self) -> None:
        """Reset the tag universe to what is actually in use and drop every
        compiled-policy cache.

        The shared :class:`TagIndex` is append-only, so a long-lived session
        fed per-request synthesised scripts (``serve.Engine``'s ``kv:<s>``
        session tags) accumulates a column for every tag *ever* seen and the
        per-decision matmuls grow with it.  ``compact()`` rebuilds the index
        from the current state + default script; callers with per-session
        tags should invoke it periodically (the engine does once the index
        outgrows a threshold).  O(one rebuild) — all caches recompile on
        demand."""
        self._compactions += 1
        self.tag_index = TagIndex([])
        self._policies.clear()
        self._last_pol = None
        self._occ_cache = None
        self.invalidate()
        if self._default_script is not None:
            self.policies_for(self._default_script)

    def _on_event(self, kind: str, payload: Dict) -> None:
        if self._snap is None:
            return
        tm = self._timers
        if tm is not None:
            # inlined tm.sample(): this fires on every state mutation, so
            # the unsampled passes pay only the counter advance
            t = (tm.tick + 1) & tm.mask
            tm.tick = t
            if t == 0:
                t0 = perf_counter()
                self._apply_event(kind, payload)
                tm.observe("delta_apply", perf_counter() - t0)
                return
        self._apply_event(kind, payload)

    def _apply_event(self, kind: str, payload: Dict) -> None:
        if self._wave_watch is not None:
            self._wave_watch.append((kind, payload))
        try:
            if kind == "allocate":
                a = payload["activation"]
                self._snap.apply_alloc(a.worker, a.tag, a.memory,
                                       a.activation_id, self.tag_index)
            elif kind == "complete":
                a = payload["activation"]
                self._snap.apply_release(a.worker, a.tag, a.memory,
                                         a.activation_id, self.tag_index)
            elif kind == "add_worker":
                if payload["reused"]:
                    # a re-joining worker keeps its original conf slot; an
                    # append would put it at the wrong position — rebuild
                    self.invalidate()
                    return
                self._snap.apply_add_worker(payload["worker"],
                                            payload["max_memory"],
                                            payload.get("zone", ""))
                self._worker_epoch += 1
            elif kind == "fail_worker":
                self._snap.apply_drop_worker(payload["worker"])
                self._worker_epoch += 1
            else:  # unknown event kind: be safe
                self.invalidate()
                return
            self._synced_version = self.state.version
            self.stats["deltas"] += 1
        except Exception:
            self.invalidate()

    def tensors(self) -> StateTensors:
        if self._snap is None or self._synced_version != self.state.version:
            self._snap = StateTensors.from_state(self.state, self.tag_index)
            self._synced_version = self.state.version
            self._worker_epoch += 1
            self.stats["rebuilds"] += 1
        return self._snap

    # ---- compiled policy cache --------------------------------------------- #

    def set_default_script(self, script) -> None:
        """Install (or hot-swap) the session's default script.

        Accepts a plain :class:`AAppScript` or a pre-lowered
        :class:`repro_torch.core.compile.CompiledScript`.  A compiled script's row
        banks are adopted wholesale when its tag universe *is* the session's
        (the `Platform.reload_script` path compiles into the live index) or
        when the session is still pristine; otherwise only its AST is taken
        and the rows recompile lazily against the session's own index."""
        compiled = None
        if hasattr(script, "ir_version"):  # CompiledScript (no import cycle)
            compiled = script
            script = compiled.script
        if compiled is not None:
            if compiled.tag_index is not self.tag_index and not self._policies \
                    and self._snap is None and len(self.tag_index) == 0:
                self.tag_index = compiled.tag_index  # pristine: adopt universe
            if compiled.tag_index is self.tag_index:
                self._policies[script] = compiled.policies
                self._policies.move_to_end(script)
        self._default_script = script
        self._last_pol = None
        self.policies_for(script)

    def policies_for(self, script=None) -> CompiledPolicies:
        script = script if script is not None else self._default_script
        if script is None:
            raise ValueError("no script: pass one or set a session default")
        if hasattr(script, "ir_version"):  # CompiledScript per-call override
            script = script.script
        last = self._last_pol
        if last is not None and last[0] is script:
            return last[1]
        pol = self._policies.get(script)
        if pol is None:
            self.tag_index.ensure_script(script, self.reg)
            pol = CompiledPolicies(script, self.reg, tag_index=self.tag_index)
            self._policies[script] = pol
            if len(self._policies) > self._max_cached_scripts:
                self._policies.popitem(last=False)
        else:
            self._policies.move_to_end(script)
        self._last_pol = (script, pol)
        return pol

    # ---- warmth ------------------------------------------------------------ #

    def _resolve_warmth(self, f: str, warmth, snap: StateTensors):
        """Returns ``(warm_vec, warmth_fn)``: a dense [W] rank vector when the
        pool's sparse residency table backs it (vectorized tier-narrowing), or
        a callable for explicitly supplied warmth; both None when off."""
        if warmth == "auto":
            if self.pool is None:
                return None, None
            row = self.pool.warmth_row(f, self.clock())
            if not row:
                return None, None
            vec = np.zeros((len(snap.workers),), np.int32)
            widx = snap.widx
            if len(row) > len(widx):
                # cluster-wide row, zone-shard tensors: walk the smaller side
                get = row.get
                hit = False
                for w, j in widx.items():
                    r = get(w)
                    if r is not None:
                        vec[j] = r
                        hit = True
                if not hit:
                    return None, None
            else:
                try:
                    idx = np.fromiter(map(widx.__getitem__, row),
                                      np.intp, count=len(row))
                except KeyError:  # row mentions workers this shard lacks
                    for w, r in row.items():
                        j = widx.get(w)
                        if j is not None:
                            vec[j] = r
                else:
                    vec[idx] = np.fromiter(row.values(), np.int32,
                                           count=len(row))
            return vec, None
        if warmth is None:
            return None, None
        return None, warmth

    # ---- decisions --------------------------------------------------------- #

    def _valid_rows(self, bank: TagRows, snap: StateTensors, wmask: np.ndarray,
                    f_mem: float) -> np.ndarray:
        """Lean batched Listing-1 ``valid`` for one tag's rows on the live
        tensors — same math as ``affinity_valid_ref_np`` (float32 matmul
        violation counts), with the worker-occupancy complements cached per
        tensor revision and the per-row capacity/concurrency terms evaluated
        only for rows that carry such a rule."""
        occ = snap.occ
        cache = self._occ_cache
        if cache is None or cache[0] is not occ or cache[1] != snap.rev:
            empty = (occ == 0).astype(np.float32)  # [W, T]
            cache = (occ, snap.rev, empty.T.copy(), (1.0 - empty).T.copy())
            self._occ_cache = cache
        _, _, emptyT, presentT = cache
        violations = bank.pos @ emptyT + bank.neg @ presentT  # [B, W]
        ok = (violations == 0.0) & wmask
        # float64 throughout, mirroring the scalar reference's python-float
        # comparisons (lines 19 / 22-24 of Listing 1) bit for bit
        ok &= (snap.mem_used + float(f_mem) <= snap.max_mem)[None, :]
        if bank.cap_rows.size:
            sel = bank.cap_rows
            ok[sel] &= (snap.mem_used[None, :]
                        < (bank.cap[sel][:, None] / 100.0)
                        * snap.max_mem[None, :])
        if bank.conc_rows.size:
            sel = bank.conc_rows
            ok[sel] &= snap.n_funcs[None, :] < bank.conc[sel][:, None]
        return ok

    def _decide(self, f: str, pol: CompiledPolicies, snap: StateTensors,
                rng, warmth, only: Optional[Sequence[int]] = None
                ) -> Optional[str]:
        """One Listing-1 decision on the live tensors.  ``only`` (internal,
        used by the sharded router) restricts the scan to a subset of the
        tag's bank rows, in the given order — Listing-1 semantics over a
        router-chosen slice of the chain."""
        self.stats["decisions"] += 1
        spec = self.reg[f]  # raises KeyError like the scalar reference
        W = len(snap.workers)
        bank = pol.rows_for(spec.tag)
        B = len(bank.cbs)
        if B == 0 or W == 0:
            return None
        T = len(self.tag_index)
        snap.ensure_tags(T)
        aff = bank.aff_at(T)
        if snap.occ.shape[1] > T:  # tensors saw tags no script references
            aff = np.concatenate(
                [aff, np.zeros((B, snap.occ.shape[1] - T), np.int8)], axis=1)
            bank.aff = aff
            bank._derive()
        tm = self._timers
        # one sampled gate per decision: when it fires, both decision-path
        # stages (mask build, strategy select) are timed.  Inlined
        # tm.sample() — a method call here is measurable against the
        # enabled-path budget
        timed = False
        if tm is not None:
            _tk = (tm.tick + 1) & tm.mask
            tm.tick = _tk
            timed = _tk == 0
        if timed:
            _t0 = perf_counter()
            wmask = self._wmask(pol, spec.tag, bank, snap)
            tm.observe("mask_build", perf_counter() - _t0)
        else:
            wmask = self._wmask(pol, spec.tag, bank, snap)
        if self.backend == "np":
            valid = self._valid_rows(bank, snap, wmask, spec.memory)
        else:
            f_mem = np.full((B,), spec.memory, np.float32)
            valid = affinity_valid_np(
                snap.occ, aff, wmask, snap.mem_used, snap.max_mem,
                snap.n_funcs, f_mem, bank.cap, bank.conc,
                device=self.device)  # [B, W]
        warm_vec, warmth_fn = self._resolve_warmth(f, warmth, snap)
        workers = snap.workers
        n_funcs = snap.n_funcs
        if warm_vec is not None:
            rank_of = lambda j: int(warm_vec[j])
        elif warmth_fn is not None:
            rank_of = lambda j: int(warmth_fn(f, workers[j]))
        else:
            rank_of = lambda j: 0
        ctx = SelectionContext(load=lambda j: int(n_funcs[j]), warmth=rank_of)
        tr = self._tracer
        vlist = None
        conf = None
        if tr is not None and tr.verdicts:
            # verdict mode (the explain-agreement surface, off the perf
            # budget): per evaluated block, every considered worker's
            # verdict — validity from the *tensor* row, reason strings from
            # the scalar `rejection_reason` on the live conf, so a tensor/
            # scalar divergence shows up as a trace-vs-explain mismatch
            vlist = []
            conf = self.state.conf()
        warm_on = warm_vec is not None or warmth_fn is not None
        for b in (range(B) if only is None else only):
            cb = bank.cbs[b]
            row = valid[b]
            strat = get_strategy(cb.strategy)
            if vlist is not None:
                vlist.append((b, self._block_verdicts(
                    f, cb, strat, row, snap, conf, rank_of, warm_on)))
            if cb.wildcard:
                cand = np.flatnonzero(row)  # conf order
                if cand.size == 0:
                    continue
                if strat.narrow_warmth:
                    if warm_vec is not None:
                        ranks = warm_vec[cand]
                        best = int(ranks.max())
                        if best > 0:
                            cand = cand[ranks == best]
                    elif warmth_fn is not None:
                        ranks = [warmth_fn(f, workers[j]) for j in cand]
                        best = max(ranks)
                        cand = [j for j, r in zip(cand, ranks) if r == best]
            else:
                widx = snap.widx
                cand = [widx[w] for w in cb.worker_ids
                        if w in widx and row[widx[w]]]
                if not cand:
                    continue
                if strat.narrow_warmth and warm_on:
                    ranks = [rank_of(j) for j in cand]
                    best = max(ranks)
                    cand = [j for j, r in zip(cand, ranks) if r == best]
            if timed:
                _t0 = perf_counter()
                jj = int(strat.select(cand, ctx, rng))
                tm.observe("strategy_select", perf_counter() - _t0)
            else:
                jj = int(strat.select(cand, ctx, rng))
            w = workers[jj]
            if tr is not None:
                tr.blocks(f, b, w, None if vlist is None else tuple(vlist))
            return w
        if tr is not None:
            tr.blocks(f, None, None,
                      None if vlist is None else tuple(vlist))
        return None

    def _block_verdicts(self, f: str, cb: CompiledBlock, strat, row,
                        snap: StateTensors, conf, rank_of,
                        warm_on: bool) -> Tuple:
        """Verdict-mode trace of one block: ``(worker, ok, reason)`` per
        considered worker in the reference candidate order, with validity
        read off the tensor ``valid`` row and reason strings from the
        scalar :func:`repro_torch.core.scheduler.rejection_reason` — the same
        vocabulary (and the same warmth-tier drop rule) `explain()` uses."""
        widx = snap.widx
        order = (snap.workers if cb.wildcard else cb.worker_ids)
        entries: List[List] = []
        for w in order:
            j = widx.get(w)
            if j is None:
                entries.append([w, False, REASON_UNKNOWN_WORKER, -1])
            elif row[j]:
                entries.append([w, True, None, j])
            else:
                entries.append([w, False,
                                rejection_reason(f, w, conf, self.reg,
                                                 cb.block), j])
        if warm_on and strat.narrow_warmth:
            oks = [e for e in entries if e[1]]
            if oks:
                best = max(rank_of(e[3]) for e in oks)
                if best > 0:
                    for e in oks:
                        if rank_of(e[3]) != best:
                            e[1] = False
                            e[2] = REASON_WARMTH_TIER
        return tuple((w, ok, reason) for w, ok, reason, _j in entries)

    def _wmask(self, pol: CompiledPolicies, tag: str, bank: TagRows,
               snap: StateTensors) -> np.ndarray:
        if bank.wmask is not None and bank.wmask_epoch == self._worker_epoch:
            return bank.wmask
        W = len(snap.workers)
        wmask = np.zeros((len(bank.cbs), W), bool)
        for b, cb in enumerate(bank.cbs):
            if cb.wildcard:
                wmask[b, :] = True
            else:
                for wid in cb.worker_ids:
                    j = snap.widx.get(wid)
                    if j is not None:
                        wmask[b, j] = True
            if cb.zones or cb.anti_zones:  # v2 zone terms: candidacy mask
                for j, z in enumerate(snap.zones):
                    if not cb.admits_zone(z):
                        wmask[b, j] = False
        bank.wmask = wmask
        bank.wmask_epoch = self._worker_epoch
        return wmask

    def try_schedule(self, f: str, *, script: Optional[AAppScript] = None,
                     rng: Optional[random.Random] = None,
                     warmth="auto") -> Optional[str]:
        """Single Listing-1 decision against the live tensors; returns the
        worker id or ``None``.  Does *not* allocate — callers record the
        decision via ``state.allocate`` and the change feed keeps the
        session's tensors in lockstep."""
        rng = rng if rng is not None else default_rng()
        pol = self.policies_for(script)
        snap = self.tensors()
        return self._decide(f, pol, snap, rng, warmth)

    def schedule_wave(self, fs: Sequence[str], *,
                      script: Optional[AAppScript] = None,
                      rng: Optional[random.Random] = None,
                      warmth="auto",
                      apply_to: Optional[ClusterState] = None) -> WaveResult:
        """Schedule ``fs`` in order with exact sequential semantics.

        ``apply_to`` must be the session's own state (allocations are recorded
        there and flow back as deltas) or ``None`` (the wave is simulated on a
        scratch copy of the tensors; the session's live tensors are
        untouched).
        """
        if apply_to is not None and apply_to is not self.state:
            raise ValueError("apply_to must be the session's state or None")
        rng = rng if rng is not None else default_rng()
        pol = self.policies_for(script)
        self.stats["waves"] += 1
        live = apply_to is not None
        snap = self.tensors() if live else self.tensors().copy()
        assignments: List[Optional[str]] = []
        rows = 0
        for i, f in enumerate(fs):
            w = self._decide(f, pol, snap if not live else self.tensors(),
                             rng, warmth)
            rows += len(pol.rows_for(self.reg[f].tag).cbs)
            assignments.append(w)
            if w is None:
                continue
            if live:
                apply_to.allocate(f, w, self.reg)  # delta via change feed
            else:
                spec = self.reg[f]
                snap.apply_alloc(w, spec.tag, spec.memory, f"~wave{i}",
                                 self.tag_index)
        return WaveResult(assignments=assignments, rows_evaluated=rows,
                          corrections=0)

    # ---- bulk decide (the group-commit batching front end) ----------------- #

    def decide_wave(self, fs: Sequence[str], *,
                    script: Optional[AAppScript] = None,
                    rng: Optional[random.Random] = None,
                    warmth="auto",
                    apply_to: Optional[ClusterState] = None,
                    commit: Optional[Callable[[int, str, Optional[str]], None]]
                    = None) -> WaveResult:
        """Group-commit a wave of decisions with exact sequential semantics
        through one fused bulk pass.

        Instead of a full :meth:`_decide` per item, the wave evaluates every
        distinct function's block bank once against the wave-start tensors —
        candidate masks *and* strategy scores in a single [R, W] pass
        (``self.backend``: the float64 numpy twin, or float32 through the
        CUDA kernel / its plain PyTorch version on ``self.device``) — and
        then commits items in order, maintaining each
        row's cached argmin winner by re-checking only the workers dirtied by
        earlier commits in the same wave.  Monotonicity does the heavy
        lifting: a placement can only *worsen* a worker's validity and score
        (memory, capacity, concurrency, load, anti-affinity) except when it
        lands an affine tag, so a cached winner stays the winner until it is
        itself dirtied, and untouched rows cost nothing.  The one other
        exception is live pool warmth: a cold start on a worker evicts idle
        containers there to make room, and the container the keep-alive
        policy serves next can be a hotter one, so every row re-checks each
        committed worker instead of deferring it.

        Anything the score encoding can't express bit-identically falls back
        to the per-item reference path: non-wildcard blocks, strategies
        outside the built-in four (notably ``any``, which draws from ``rng``
        — fallback preserves the draw sequence since vectorized strategies
        never draw), unknown functions, explicit warmth callables, and whole
        waves when a tracer is attached.  Mid-wave structural events —
        ``complete``/worker churn deltas, an :meth:`invalidate`, or a
        :meth:`compact` (which rebuilds the tag universe and would strand
        in-flight tag-row indices) — rebuild the wave state for the
        remaining suffix from the live tensors, which is exactly wave-start
        semantics for that suffix.

        ``apply_to`` must be the session's own state (live mode: each
        decision is recorded — by ``commit`` when given, else directly via
        ``state.allocate`` — before the next is made) or ``None`` (scratch
        mode: decisions are as-if-applied on a copy of the tensors, nothing
        mutates).  ``commit(i, f, worker)`` is invoked for every item,
        including unplaced ones (``worker is None``) so callers can mirror
        their full per-invoke bookkeeping.

        With ``backend="np"`` (the default) the result is bit-identical to
        calling :meth:`try_schedule` in a loop with the same rng — scores
        are float64 with the scalar reference's exact operation sequence.
        The ``torch`` backend scores in float32 (``min_cost`` uses the exact
        20x-scaled integer encoding) and carries the same near-tie caveat
        as its validity kernel: bit-identical to the JAX reference's
        ``ref`` backend, and to ``np`` except on a rational ``min_cost`` tie
        that float64 rounding breaks.
        """
        if apply_to is not None and apply_to is not self.state:
            raise ValueError("apply_to must be the session's state or None")
        live = apply_to is not None
        if commit is not None and not live:
            raise ValueError("commit requires apply_to (live mode)")
        rng = rng if rng is not None else default_rng()
        self.stats["waves"] += 1
        self.stats["bulk_waves"] += 1
        tm = self._timers
        timed = False
        if tm is not None:
            timed = tm.sample()
            if timed:
                _t0 = perf_counter()
            tm.registry.histogram("session.bulk_batch_size",
                                  bounds=BULK_BATCH_BOUNDS
                                  ).observe(float(len(fs)))
        watch: Optional[List[Tuple[str, Dict]]] = [] if live else None
        if live:
            self._wave_watch = watch
        try:
            result = self._run_wave(fs, script, rng, warmth, live, apply_to,
                                    commit, watch)
        finally:
            self._wave_watch = None
        if timed:
            tm.observe("bulk_decide", perf_counter() - _t0)
        return result

    def _run_wave(self, fs, script, rng, warmth, live, apply_to, commit,
                  watch) -> WaveResult:
        reg = self.reg
        f32 = self.backend != "np"
        INF = np.inf
        # only pool-backed ("auto") or absent warmth is vectorizable: an
        # explicit callable could read state a commit mutates mid-wave
        vec_warmth = warmth == "auto" or warmth is None
        use_pool_warm = live and warmth == "auto" and self.pool is not None
        corrections = 0
        rows_evaluated = 0
        events: List[Tuple[int, Optional[int]]] = []  # (worker idx, tag col)
        watch_pos = 0
        structural = False

        pol = self.policies_for(script)
        snap = self.tensors()
        epoch0 = self._worker_epoch
        compact0 = self._compactions
        fstates: Dict[str, Optional[_WaveFn]] = {}
        # scratch overlays (turbo mode): per-worker float64/int mirrors of
        # the as-if-applied deltas, so an all-vectorizable scratch wave
        # never copies or writes the tensors at all.  The accumulation is
        # the same IEEE operation sequence as += into the arrays (a python
        # float *is* a float64), so reads through the overlay are bit-exact.
        turbo = False
        mem_over: Dict[int, float] = {}
        load_over: Dict[int, int] = {}
        occ_over: Dict[Tuple[int, int], int] = {}

        # ---- wave-start bulk pass ------------------------------------------ #

        def build(funcs) -> None:
            nonlocal rows_evaluated
            pending = []
            for f in funcs:
                if f in fstates:
                    continue
                if self._tracer is not None or not vec_warmth:
                    fstates[f] = None  # exact per-item path (trace records)
                    continue
                try:
                    spec = reg[f]
                except KeyError:
                    fstates[f] = None  # _decide raises at the item's turn
                    continue
                bank = pol.rows_for(spec.tag)
                codes: List[int] = []
                vec = True
                for cb in bank.cbs:
                    code = None
                    if cb.wildcard:
                        try:
                            code = _VEC_STRATEGIES.get(
                                type(get_strategy(cb.strategy)))
                        except KeyError:
                            code = None
                    if code is None:
                        vec = False
                        break
                    codes.append(code)
                if not vec:
                    fstates[f] = None
                    self.stats["bulk_fallback"] += 1
                    continue
                pending.append((f, spec, bank, codes))
            if not pending:
                return
            W = len(snap.workers)
            T = len(self.tag_index)
            snap.ensure_tags(T)
            ready = []
            for f, spec, bank, codes in pending:
                B = len(bank.cbs)
                if B == 0 or W == 0:
                    fstates[f] = _WaveFn(f, spec.tag, float(spec.memory),
                                         [], None)
                    continue
                aff = bank.aff_at(T)
                if snap.occ.shape[1] > T:  # tensors saw unreferenced tags
                    aff = np.concatenate(
                        [aff, np.zeros((B, snap.occ.shape[1] - T), np.int8)],
                        axis=1)
                    bank.aff = aff
                    bank._derive()
                wmask = self._wmask(pol, spec.tag, bank, snap)
                warm_vec, _fn = self._resolve_warmth(f, warmth, snap)
                if use_pool_warm and warm_vec is None:
                    warm_vec = np.zeros((W,), np.int32)  # mutable: acquires
                ready.append((f, spec, bank, codes, wmask, warm_vec))
                rows_evaluated += B
            if not ready:
                return

            def adopt(f, spec, bank, codes, wmask, warm_vec, valid, score,
                      winners):
                rows = []
                for b, cb in enumerate(bank.cbs):
                    k = int(winners[b])
                    ws = float(score[b, k]) if k >= 0 else INF
                    rows.append(_WaveRow(cb, wmask[b], codes[b],
                                         score[b].copy(), k, ws))
                fstates[f] = _WaveFn(f, spec.tag, float(spec.memory), rows,
                                     warm_vec)

            if not f32:
                for f, spec, bank, codes, wmask, warm_vec in ready:
                    valid = self._valid_rows(bank, snap, wmask, spec.memory)
                    score = bulk_scores_np(
                        valid, codes, 0 if warm_vec is None else warm_vec,
                        snap.n_funcs)
                    adopt(f, spec, bank, codes, wmask, warm_vec, valid, score,
                          bulk_argmin_np(score))
                return
            # float32 on the device: one fused [R, W] launch across every
            # pending function's rows
            Tocc = snap.occ.shape[1]
            affs, wms, fmems, caps, concs, strats = [], [], [], [], [], []
            Rtot = sum(len(bank.cbs) for _, _, bank, _, _, _ in ready)
            warm_all = np.zeros((Rtot, len(snap.workers)), np.int32)
            r0 = 0
            for f, spec, bank, codes, wmask, warm_vec in ready:
                B = len(bank.cbs)
                affs.append(bank.aff_at(Tocc))
                wms.append(wmask)
                if warm_vec is not None:
                    warm_all[r0:r0 + B] = warm_vec
                fmems.append(np.full((B,), spec.memory, np.float32))
                caps.append(bank.cap.astype(np.float32))
                concs.append(bank.conc)
                strats.append(np.asarray(codes, np.int32))
                r0 += B
            valid_all, score_all, winner_all = bulk_decide_np(
                snap.occ, np.concatenate(affs), np.concatenate(wms),
                snap.mem_used, snap.max_mem, snap.n_funcs,
                np.concatenate(fmems), np.concatenate(caps),
                np.concatenate(concs), np.concatenate(strats),
                warm_all, device=self.device)
            score_all = np.asarray(score_all)
            r0 = 0
            for f, spec, bank, codes, wmask, warm_vec in ready:
                B = len(bank.cbs)
                adopt(f, spec, bank, codes, wmask, warm_vec,
                      valid_all[r0:r0 + B], score_all[r0:r0 + B],
                      winner_all[r0:r0 + B])
                r0 += B

        # ---- live-state change tracking ------------------------------------ #

        def drain() -> None:
            nonlocal watch_pos, structural
            while watch_pos < len(watch):
                kind, payload = watch[watch_pos]
                watch_pos += 1
                if kind == "allocate":
                    a = payload["activation"]
                    j = snap.widx.get(a.worker)
                    if j is None:
                        structural = True
                        continue
                    col = self.tag_index.index.get(a.tag) if a.tag else None
                    events.append((j, col))
                else:  # complete / worker churn / unknown: not monotonic
                    structural = True
            if (self._snap is not snap
                    or self._synced_version != self.state.version
                    or self._worker_epoch != epoch0
                    or self._compactions != compact0):
                structural = True

        def rebuild(remaining) -> None:
            nonlocal snap, structural, epoch0, compact0, watch_pos, pol
            pol = self.policies_for(script)  # compact() drops the old one
            snap = self.tensors()
            epoch0 = self._worker_epoch
            compact0 = self._compactions
            watch_pos = len(watch)  # everything so far is in the fresh snap
            events.clear()
            fstates.clear()
            structural = False
            build(remaining)

        # ---- cached-winner maintenance ------------------------------------- #

        occ_arr = None  # buffer view over snap.occ, refreshed on identity
        occ_mv = None  # change (scratch copy, live growth, rebuild)
        occ_w = 0

        def cell(st: _WaveFn, row: _WaveRow, j: int) -> float:
            """Live re-check of one (row, worker) cell: validity + score with
            the same arithmetic as the wave-start bulk pass (float64 for the
            np backend, f32-exact encodings for the torch backend)."""
            nonlocal corrections, occ_arr, occ_mv, occ_w
            corrections += 1
            if not row.wm_mv[j]:
                return INF
            load = load_over.get(j)
            if load is None:
                load = int(snap.n_funcs[j])
            mem = mem_over.get(j)
            if mem is None:
                mem = float(snap.mem_used[j])
            if f32:
                cut = row.thr.get(j)
                if cut is None:
                    cut = row.thr[j] = _f32_cell_cut(
                        st.f_mem32, row.cap32, snap.max_mem[j])
                if not (mem < cut):
                    return INF
                if not (load < row.maxc):
                    return INF
            else:
                maxm = float(snap.max_mem[j])
                if not (mem + st.f_mem <= maxm):
                    return INF
                if row.has_cap and not (mem < row.cap64 * maxm):
                    return INF
                if row.has_conc and load >= row.maxc:
                    return INF
            if row.pos_list or row.neg_list:
                if snap.occ is not occ_arr:  # (re)snap the buffer view
                    occ_arr = snap.occ
                    occ_mv = memoryview(occ_arr)
                    occ_w = occ_arr.shape[1]
                for c in row.pos_list:
                    v = occ_over.get((j, c))
                    if v is None:
                        v = occ_mv[j, c] if c < occ_w else 0
                    if v == 0:
                        return INF
                for c in row.neg_list:
                    v = occ_over.get((j, c))
                    if v is None:
                        v = occ_mv[j, c] if c < occ_w else 0
                    if v > 0:
                        return INF
            if st.warm is None:
                r = 0
            elif use_pool_warm:
                r = int(self.pool.warmth(st.f, snap.workers[j], self.clock()))
                st.warm[j] = r
            else:
                r = st.warm_mv[j]
            r = 0 if r < 0 else (2 if r > 2 else r)
            code = row.code
            if code == 0:  # best_first
                return 2.0 - r
            if f32:
                if code == 1:  # least_loaded
                    return float(np.float32(load))
                if code == 2:  # warmest
                    return (2.0 - r) * _WARMEST_BASE32 + min(
                        float(load), _WARMEST_BASE32 - 1.0)
                return _MIN_COST_LIFE20[r] + min(float(load),
                                                 _MIN_COST_CLAMP32)
            if code == 1:
                return float(load)
            if code == 2:
                return (2.0 - r) * _WARMEST_BASE + load
            return _BULK_LIFECYCLE[r] + _BULK_CONGESTION * load

        def reargmin(st: _WaveFn, row: _WaveRow) -> None:
            for j in row.stale:
                row.score[j] = cell(st, row, j)
            row.stale.clear()
            k = int(np.argmin(row.score))
            v = float(row.score[k])
            if v == INF:
                row.winner, row.wscore = -1, INF
            else:
                row.winner, row.wscore = k, v

        def recheck(st: _WaveFn, row: _WaveRow, j: int) -> None:
            row.stale.discard(j)
            new = cell(st, row, j)
            old_w = row.winner
            if j == old_w:
                if new == row.wscore:
                    return  # unchanged: score[j] already holds this value
                row.score[j] = new
                if new > row.wscore:
                    # the cached winner degraded (filled up, lost a
                    # tier): fold in every deferred entry and re-scan
                    reargmin(st, row)
                else:
                    row.wscore = new
                return
            row.score[j] = new
            if new < row.wscore or (new == row.wscore and j < old_w):
                row.winner, row.wscore = j, new

        def update_row(st: _WaveFn, row: _WaveRow, dirty) -> None:
            must = None
            for j, cols in dirty.items():
                if j == row.winner or use_pool_warm or (
                        row.pos_cols and cols
                        and not row.pos_cols.isdisjoint(cols)):
                    if must is None:
                        must = []
                    must.append(j)
                else:
                    row.stale.add(j)
            if must is None:
                return
            for j in must:
                recheck(st, row, j)

        def wave_pick(st: _WaveFn) -> int:
            n = len(events)
            for row in st.rows:  # Listing-1 block order
                s = row.seq
                if s < n:
                    row.seq = n
                    if n - s == 1:  # common case: one commit since last pick
                        j, col = events[s]
                        if j == row.winner or use_pool_warm or (
                                col is not None and col in row.pos_cols):
                            recheck(st, row, j)
                        else:
                            row.stale.add(j)
                    else:
                        dirty: Dict[int, set] = {}
                        for j, col in events[s:n]:
                            ds = dirty.get(j)
                            if ds is None:
                                ds = dirty[j] = set()
                            if col is not None:
                                ds.add(col)
                        update_row(st, row, dirty)
                if row.winner >= 0:
                    return row.winner
            return -1

        # ---- commit loop ---------------------------------------------------- #

        def scratch_apply(f: str, w_idx: int,
                          st: Optional[_WaveFn] = None) -> None:
            # mirrors StateTensors.apply_alloc bit for bit (extending a
            # sequential float64 sum == re-summing with the new term last)
            # without the resident-table bookkeeping scratch mode never reads
            if st is not None:
                col = st.col
                if col == -2:  # resolve the tag column once per wave
                    col = (self.tag_index.ensure(st.tag) if st.tag
                           else None)
                    if col is not None:
                        snap.ensure_tags(len(self.tag_index))
                    st.col = col
                mem = st.f_mem
            else:
                spec = reg[f]
                col = self.tag_index.ensure(spec.tag) if spec.tag else None
                if col is not None:
                    snap.ensure_tags(len(self.tag_index))
                mem = float(spec.memory)
            if col is not None:
                snap.occ[w_idx, col] += 1
            snap.mem_used[w_idx] += mem
            snap.n_funcs[w_idx] += 1
            snap.rev += 1
            events.append((w_idx, col))

        def scratch_apply_turbo(st: _WaveFn, j: int) -> None:
            # overlay-only as-if-apply: same value sequence as the array
            # twin above, no tensor writes at all
            col = st.col
            if col == -2:
                col = self.tag_index.ensure(st.tag) if st.tag else None
                st.col = col
            if col is not None:
                k = (j, col)
                v = occ_over.get(k)
                if v is None:
                    r = snap.occ[j]
                    v = int(r[col]) if col < r.shape[0] else 0
                occ_over[k] = v + 1
            m = mem_over.get(j)
            if m is None:
                m = float(snap.mem_used[j])
            mem_over[j] = m + st.f_mem
            l = load_over.get(j)
            if l is None:
                l = int(snap.n_funcs[j])
            load_over[j] = l + 1
            events.append((j, col))

        build(list(dict.fromkeys(fs)))
        if not live:
            turbo = all(st is not None for st in fstates.values())
            if not turbo:
                # a fallback item runs the vectorized per-item reference
                # against the snap arrays, so they must really mutate
                snap = snap.scratch_copy()
        picks = 0
        wname: Dict[int, str] = {}  # winner-index -> id memo (few distinct)
        assignments: List[Optional[str]] = []
        if turbo and commit is None:
            # scratch overlay fast path: every item is a vectorized pick
            # with no live feed, per-item callback, or tensor writes —
            # the amortized-microseconds loop the bulk budget is set on
            append = assignments.append
            workers = snap.workers
            for f in fs:
                st = fstates[f]
                k = wave_pick(st)
                if k >= 0:
                    w = wname.get(k)
                    if w is None:
                        w = wname[k] = workers[k]
                    scratch_apply_turbo(st, k)
                else:
                    w = None
                append(w)
            self.stats["decisions"] += len(fs)
            return WaveResult(assignments=assignments,
                              rows_evaluated=rows_evaluated,
                              corrections=corrections)
        for i, f in enumerate(fs):
            if live:
                drain()
                if structural:
                    rebuild(list(dict.fromkeys(fs[i:])))
                    wname.clear()
            st = fstates.get(f)
            if st is None:
                w = self._decide(f, pol, snap, rng, warmth)
                k = -1 if w is None else snap.widx[w]
            else:
                picks += 1
                k = wave_pick(st)
                if k >= 0:
                    w = wname.get(k)
                    if w is None:
                        w = wname[k] = snap.workers[k]
                else:
                    w = None
            assignments.append(w)
            if commit is not None:
                commit(i, f, w)
            elif w is not None:
                if live:
                    apply_to.allocate(f, w, reg)  # delta via change feed
                elif turbo:
                    scratch_apply_turbo(st, k)
                else:
                    scratch_apply(f, k, st)
        self.stats["decisions"] += picks
        return WaveResult(assignments=assignments,
                          rows_evaluated=rows_evaluated,
                          corrections=corrections)
