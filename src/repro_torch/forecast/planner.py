"""Planning epochs — the decision half of the forecast subsystem.

Each epoch the planner assembles the cluster into the same tensor shapes the
batched scheduler uses (`core/batched.py` style): a ``demand[F]`` vector of
predicted arrivals, a ``residency[W, F]`` matrix of idle-container counts, a
``busy[F]`` in-flight vector and ``free_mb[W]`` pool headroom — then emits a
budget-feasible action list:

* **prewarm** — start a container ahead of predicted demand.  Placement only
  ever targets workers where the *real* Listing-1 ``core.scheduler.valid``
  holds for one of the function's candidate blocks, preferring the earliest
  (most specific) block — so an ``impera`` prewarm chases the worker where a
  ``divide`` is resident, exactly like live scheduling would;
* **migrate** — move an idle container from a worker the function's policy
  currently ranks poorly (e.g. its affinity target left) to the best-ranked
  worker with headroom, at a transfer cost between a warm and a cold start;
* **retire** — proactively retire idle containers of functions whose
  predicted demand has collapsed, freeing budget for prewarms.

The planner never evicts to make room (that stays the pool's pressure path)
and never exceeds the per-worker pool budget: ``free_mb`` is debited as
actions accumulate, so the emitted list is feasible as a whole.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.compile import CompiledScript, compile_script
from repro_torch.core.scheduler import valid

from .estimator import ArrivalForecast


# --------------------------------------------------------------------------- #
# actions
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class Prewarm:
    function: str
    worker: str
    memory: float
    tag: str


@dataclasses.dataclass(frozen=True)
class Migrate:
    function: str
    src: str
    dst: str


@dataclasses.dataclass(frozen=True)
class Retire:
    function: str
    worker: str


Action = object  # Prewarm | Migrate | Retire


@dataclasses.dataclass(frozen=True)
class PlanConfig:
    horizon: float = 6.0  # prediction window (s)
    startup_slack: float = 1.0  # reaction time added to service in sizing
    prewarm_threshold: float = 0.5  # min expected arrivals to hold/prewarm
    retire_threshold: float = 0.05  # below this the pool lets go
    surplus_slack: int = 2  # hysteresis band before surplus retirement
    max_prewarms: int = 6  # per epoch
    max_migrations: int = 3
    max_retires: int = 3


class ForecastPlanner:
    """Turns one forecast snapshot + one pool snapshot into an action list."""

    def __init__(self, forecast: ArrivalForecast, script, registry,
                 config: PlanConfig = PlanConfig()):
        self.forecast = forecast
        # the planner consumes the v2 compile pipeline's IR: resolved
        # candidate-block chains (followup/default applied once, at compile
        # time) instead of re-deriving them per (function, worker) probe.
        # A raw AAppScript is compiled here for convenience.
        if isinstance(script, CompiledScript):
            self.compiled = script
        else:
            self.compiled = compile_script(script, registry)
        self.script = self.compiled.script
        self.registry = registry
        self.cfg = config
        # planning-epoch counters — the obs registry polls these as a
        # collector, so plan() just bumps plain dict entries
        self.stats: Dict[str, int] = {
            "epochs": 0, "prewarms": 0, "migrations": 0, "retires": 0}

    # ---- validity (the real Listing-1 rule) -------------------------------- #

    def valid_rank(self, function: str, worker: str, conf) -> int:
        """Index of the first candidate block of ``function``'s policy that
        could schedule it on ``worker`` — the block must *list* the worker
        (Listing 1 lines 7-9: explicit ids or wildcard) and
        ``core.scheduler.valid`` must hold; -1 if no block qualifies."""
        tag = self.registry[function].tag
        for i, block in enumerate(self.compiled.candidate_blocks(tag)):
            if not block.is_wildcard and worker not in block.workers:
                continue
            if valid(function, worker, conf, self.registry, block):
                return i
        return -1

    # ---- the epoch --------------------------------------------------------- #

    def plan(self, conf, pool, now: float) -> List[Action]:
        self.stats["epochs"] += 1
        cfg = self.cfg
        workers: List[str] = [w for w in conf]
        if not workers:
            return []
        idle = pool.residency_counts()  # (worker, function) -> count
        busy = pool.busy_counts()  # function -> count
        pending = pool.pending_tags()

        succ = self.forecast.successor_demand(busy, cfg.horizon)
        functions = sorted(
            f for f in ({f for _w, f in idle} | set(busy)
                        | set(self.forecast.rates.keys()) | set(succ))
            if f in self.registry)
        if not functions:
            return []

        W, F = len(workers), len(functions)
        widx = {w: i for i, w in enumerate(workers)}
        fidx = {f: i for i, f in enumerate(functions)}

        # tensors, core/batched.py style
        residency = np.zeros((W, F), dtype=np.int64)
        for (w, f), n in idle.items():
            if w in widx and f in fidx:
                residency[widx[w], fidx[f]] = n
        inflight = np.array([busy.get(f, 0) for f in functions], np.int64)
        demand = np.array(
            [self.forecast.expected_arrivals(f, now, cfg.horizon)
             for f in functions], np.float64)
        demand += np.array([succ.get(f, 0.0) for f in functions], np.float64)
        mem = np.array([self.registry[f].memory for f in functions],
                       np.float64)
        free_mb = np.array(
            [math.inf if pool.budget_of(w) is None
             else pool.budget_of(w) - pool.used_mb(w) for w in workers],
            np.float64)
        # scalar Listing-1 calls, deliberately: the acceptance contract is
        # that every placement passes the *reference* valid(); at control-
        # plane scale the batched affinity_valid_np matrix is the drop-in
        rank = np.array([[self.valid_rank(f, w, conf) for f in functions]
                         for w in workers], np.int64)

        # warm-set sizing: Little's-law concurrency at the predicted rate,
        # floored by the children in-flight parents are about to spawn
        rate = demand / cfg.horizon
        svc = np.array(
            [self.forecast.service_time(f) + cfg.startup_slack
             for f in functions], np.float64)
        target = np.where(demand >= cfg.prewarm_threshold,
                          np.ceil(np.maximum(rate * svc, np.array(
                              [succ.get(f, 0.0) for f in functions]))), 0.0)
        # supply counts the in-flight fleet (it parks back idle when it
        # finishes) plus the idle containers the scheduler can currently
        # *reach*: an affinity-constrained function (whose first valid block
        # narrows to a strict worker subset) gains nothing from idle
        # containers stranded on lower-ranked workers
        best_rank = np.where(
            (rank >= 0).any(axis=0),
            np.min(np.where(rank >= 0, rank, np.iinfo(np.int64).max), axis=0),
            -1)
        reachable = (rank == best_rank[None, :]) & (best_rank[None, :] >= 0)
        supply = (residency * reachable).sum(axis=0) + inflight
        need = np.maximum(target - supply, 0.0).astype(np.int64)

        actions: List[Action] = []

        # -- migrate: stranded idle containers -> the best-ranked worker ---- #
        n_migrations = 0
        for j in np.argsort(-demand):
            if n_migrations >= cfg.max_migrations:
                break
            f = functions[j]
            if demand[j] < cfg.prewarm_threshold:
                continue
            if best_rank[j] < 0:
                continue
            best_set = rank[:, j] == best_rank[j]
            stranded = np.where(
                (residency[:, j] > 0)
                & ((rank[:, j] < 0) | (rank[:, j] > best_rank[j])))[0]
            # each best-ranked worker may absorb its share of the warm-set
            # target (children often spawn in pairs: one per worker is not
            # always enough)
            dst_cap = max(1, int(math.ceil(
                float(target[j]) / max(1, int(best_set.sum())))))
            for src in stranded:
                if n_migrations >= cfg.max_migrations:
                    break
                dsts = np.where(best_set & (residency[:, j] < dst_cap)
                                & (free_mb >= mem[j]))[0]
                if not len(dsts):
                    break
                dst = dsts[np.argmax(free_mb[dsts] - residency[dsts, j] * 1e3)]
                actions.append(Migrate(f, workers[src], workers[dst]))
                residency[src, j] -= 1
                residency[dst, j] += 1
                free_mb[src] += mem[j]
                free_mb[dst] -= mem[j]
                # the landed container is reachable supply now: don't also
                # prewarm for the demand this migration just satisfied
                need[j] = max(need[j] - 1, 0)
                n_migrations += 1

        # -- prewarm: highest-demand functions first ------------------------ #
        # when every candidate worker is memory-blocked, a prewarm may evict
        # *surplus* containers of other functions (supply beyond target plus
        # a hysteresis band, never pending tags) to make room — targeted
        # rebalancing, so a quiet trace never loses its retained warm set
        n_prewarms = 0
        n_retires = 0
        total_supply = residency.sum(axis=0) + inflight

        def _donate(i: int, needed: float) -> bool:
            """Retire surplus containers on worker ``i`` until ``needed`` MB
            are free; emits nothing unless the full amount is reachable."""
            nonlocal n_retires
            donors: List[Tuple[int, int]] = []  # (count, function col)
            gain = 0.0
            for g in np.argsort(-mem):
                if gain >= needed:
                    break
                if self.registry[functions[g]].tag in pending:
                    continue
                spare = int(min(
                    residency[i, g],
                    total_supply[g] - target[g] - cfg.surplus_slack))
                if spare <= 0:
                    continue
                take = int(min(spare, math.ceil((needed - gain) / mem[g])))
                donors.append((take, g))
                gain += take * mem[g]
            if gain < needed or n_retires + sum(t for t, _g in donors) \
                    > cfg.max_retires:
                return False
            for take, g in donors:
                for _ in range(take):
                    actions.append(Retire(functions[g], workers[i]))
                    free_mb[i] += mem[g]
                    residency[i, g] -= 1
                    total_supply[g] -= 1
                    n_retires += 1
            return True

        for j in np.argsort(-need):
            f = functions[j]
            spec = self.registry[f]
            while need[j] > 0 and n_prewarms < cfg.max_prewarms:
                placeable = rank[:, j] >= 0
                fits = placeable & (free_mb >= mem[j])
                if not fits.any():
                    # best-ranked, most-spacious blocked worker may free room
                    blocked = np.where(placeable)[0]
                    if not len(blocked):
                        break
                    i = blocked[int(np.argmax(
                        -rank[blocked, j] * 1e6 + free_mb[blocked]))]
                    if not _donate(int(i), mem[j] - free_mb[i]):
                        break
                    fits = placeable & (free_mb >= mem[j])
                # earliest block wins; then spread (fewest resident), then room
                score = np.where(
                    fits,
                    -rank[:, j] * 1e6 - residency[:, j] * 1e3 + free_mb,
                    -np.inf)
                i = int(np.argmax(score))
                actions.append(Prewarm(f, workers[i], spec.memory, spec.tag))
                free_mb[i] -= mem[j]
                residency[i, j] += 1
                total_supply[j] += 1
                need[j] -= 1
                n_prewarms += 1

        # -- retire: predicted demand collapsed, nothing pending ----------- #
        for j in range(F):
            f = functions[j]
            if demand[j] >= cfg.retire_threshold:
                continue
            if self.registry[f].tag in pending:
                continue
            for i in np.where(residency[:, j] > 0)[0]:
                if n_retires >= cfg.max_retires:
                    break
                actions.append(Retire(f, workers[i]))
                free_mb[i] += mem[j]
                residency[i, j] -= 1
                n_retires += 1

        stats = self.stats
        for a in actions:
            kind = type(a).__name__
            if kind == "Prewarm":
                stats["prewarms"] += 1
            elif kind == "Migrate":
                stats["migrations"] += 1
            else:
                stats["retires"] += 1
        return actions
