"""Static reachability: can every chain actually be *placed*?

Grounded in *On the Complexity of Reachability Properties in Serverless
Function Scheduling* (arXiv 2407.14159): placement feasibility under
combined affinity + anti-affinity + zone + memory constraints is decided by
a bounded configuration-space search over an **abstracted** state space —
workers collapse into equivalence classes (same capacity, same zone, same
per-chain block admissibility), partial configurations are canonicalised
per class, and failed configurations are memoised so isomorphic branches
are explored once.  The search is exact for the group sizes aAPP chains
produce (a tag plus its transitive affinity anchors); if the state budget
is ever exhausted the pass stays silent — no diagnostic is emitted without
proof.

Two checks per author tag:

* **placement** — one instance of the tag plus one of each anchor must be
  simultaneously placeable (each instance picks any block of its tag's
  resolved chain and any admissible worker; a block's affine terms must be
  co-resident, its anti-affine terms absent, its zone terms matched, and
  worker memory respected).  A proven-impossible group raises
  ``unplaceable-chain`` (error severity — the compile fails).
* **warm co-residency** — for an affinity-bearing tag, ``k`` concurrent
  instances plus the anchors must fit *one* admissible worker's effective
  warm capacity ``min(memory, keep-alive budget)`` for ``k`` up to the
  configured concurrency bound.  A bound that cannot be met warns
  ``budget-bound-colocation`` naming the binding constraint — the chained
  scenario's divide(256) + 2 x impera(192) = 640 MB against the 512 MB
  keep-alive budget, flagged at compile time instead of as a runtime
  cold-start floor.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.ast import AAppScript, Block, DEFAULT_TAG
from repro_torch.core.compile import (
    Diagnostic,
    ResolvedPolicy,
    SEVERITY_ERROR,
    SEVERITY_WARNING,
)
from repro_torch.core.state import Registry

from .calculus import AnalysisConfig, affinity_chain, tag_footprint_mb
from .diagnostics import CODE_BUDGET_COLOCATION, CODE_UNPLACEABLE


@dataclasses.dataclass(frozen=True)
class WorkerShape:
    """The slice of a worker the static passes consult: capacity + zone."""

    name: str
    zone: str
    memory_mb: float


def as_worker_shapes(workers) -> Tuple[WorkerShape, ...]:
    """Normalise a cluster shape into sorted :class:`WorkerShape`\\ s.

    Accepts ``{name: WorkerSpec}`` (``memory_mb``/``zone``),
    ``{name: WorkerView}`` (``max_memory``/``zone`` — the live
    ``ClusterState.conf()``), ``{name: number}`` (unzoned capacities), or an
    iterable of :class:`WorkerShape`.  Sorted by name so every derived
    diagnostic is deterministic."""
    if isinstance(workers, Mapping):
        out = []
        for name, spec in workers.items():
            if isinstance(spec, WorkerShape):
                out.append(dataclasses.replace(spec, name=name))
            elif isinstance(spec, (int, float)):
                out.append(WorkerShape(name, "", float(spec)))
            else:
                mem = getattr(spec, "memory_mb", None)
                if mem is None:
                    mem = getattr(spec, "max_memory", None)
                if mem is None:
                    raise TypeError(
                        f"worker {name!r}: spec {type(spec).__name__} has "
                        "neither memory_mb nor max_memory")
                out.append(WorkerShape(
                    name, str(getattr(spec, "zone", "") or ""), float(mem)))
        return tuple(sorted(out, key=lambda s: s.name))
    return tuple(sorted(workers, key=lambda s: s.name))


def _admissible_blocks(chain: Sequence[Block], w: WorkerShape) -> Tuple[int, ...]:
    """Indices of the chain's blocks that admit ``w`` statically (worker
    list membership + zone terms; memory and residency are search-time)."""
    out = []
    for bi, b in enumerate(chain):
        if not (b.is_wildcard or w.name in b.workers):
            continue
        if not b.affinity.admits_zone(w.zone):
            continue
        out.append(bi)
    return tuple(out)


class _Exhausted(Exception):
    """Search state budget spent — feasibility unknown."""


def _placeable(
    instances: Sequence[Tuple[str, float]],  # (tag, memory) in placement order
    shapes: Sequence[WorkerShape],
    chains: Dict[str, Tuple[Block, ...]],
    config: AnalysisConfig,
) -> Optional[bool]:
    """Exact bounded search: does any (worker, block) assignment of the
    instance group satisfy all constraints?  ``None`` = budget exhausted."""
    W = len(shapes)
    tags_in_group = {t for t, _m in instances}
    # per tag: per worker, the admissible block indices (static part)
    adm: Dict[str, List[Tuple[int, ...]]] = {
        t: [_admissible_blocks(chains[t], w) for w in shapes]
        for t in tags_in_group}
    # worker equivalence classes: capacity + zone + admissibility signature
    class_of: List[int] = []
    class_key_ids: Dict[Tuple, int] = {}
    for wi, w in enumerate(shapes):
        key = (w.memory_mb, w.zone,
               tuple(adm[t][wi] for t in sorted(tags_in_group)))
        class_of.append(class_key_ids.setdefault(key, len(class_key_ids)))

    used = [0.0] * W
    res: List[Dict[str, int]] = [dict() for _ in range(W)]  # resident tag counts
    banned: List[Dict[str, int]] = [dict() for _ in range(W)]  # anti-affine
    # deferred affine checks: (worker, tag) pairs a placed block requires
    # co-resident but whose instance had not been placed yet
    pending: List[Tuple[int, str]] = []
    seen_fail = set()
    states = [0]

    def canon(idx: int):
        opened = sorted(
            (class_of[wi], used[wi], frozenset(res[wi]),
             frozenset(banned[wi]))
            for wi in range(W) if res[wi] or banned[wi])
        return (idx, tuple(opened), tuple(sorted(set(pending))))

    def dfs(idx: int) -> bool:
        states[0] += 1
        if states[0] > config.max_states:
            raise _Exhausted
        if idx == len(instances):
            return all(res[wi].get(t, 0) > 0 for wi, t in pending)
        key = canon(idx)
        if key in seen_fail:
            return False
        tag, mem = instances[idx]
        tried_fresh_class = set()
        for wi in range(W):
            fresh = not res[wi] and not banned[wi] and used[wi] == 0.0
            if fresh:
                # symmetry breaking: one untouched representative per class
                if class_of[wi] in tried_fresh_class:
                    continue
                tried_fresh_class.add(class_of[wi])
            if used[wi] + mem > shapes[wi].memory_mb:
                continue
            if banned[wi].get(tag, 0) > 0:
                continue
            for bi in adm[tag][wi]:
                b = chains[tag][bi]
                # both anti directions: this block vs residents (here), and
                # residents' blocks vs this tag (the banned[] check above)
                if any(res[wi].get(a, 0) > 0 for a in b.affinity.anti_affine):
                    continue
                new_pending = [
                    (wi, a) for a in b.affinity.affine
                    if a in tags_in_group and res[wi].get(a, 0) == 0]
                # place
                used[wi] += mem
                res[wi][tag] = res[wi].get(tag, 0) + 1
                for a in b.affinity.anti_affine:
                    banned[wi][a] = banned[wi].get(a, 0) + 1
                pending.extend(new_pending)
                if dfs(idx + 1):
                    return True
                # unplace
                for _ in new_pending:
                    pending.pop()
                for a in b.affinity.anti_affine:
                    banned[wi][a] -= 1
                    if not banned[wi][a]:
                        del banned[wi][a]
                res[wi][tag] -= 1
                if not res[wi][tag]:
                    del res[wi][tag]
                used[wi] -= mem
        seen_fail.add(key)
        return False

    try:
        return dfs(0)
    except _Exhausted:
        return None


def reachability_pass(
    script: AAppScript,
    resolved: Dict[str, ResolvedPolicy],
    reg: Registry,
    shapes: Sequence[WorkerShape],
    config: AnalysisConfig,
    budget_mb: Optional[float] = None,
) -> Tuple[Diagnostic, ...]:
    """Run both checks for every author tag against a concrete cluster.

    Tags whose footprint the registry cannot bound (no registered function)
    are skipped silently — the back-compat contract.  Diagnostics come out
    in author order; the compile driver sorts them."""
    diags: List[Diagnostic] = []
    if not shapes:
        return ()

    for p in script.policies:
        tag = p.tag
        if tag == DEFAULT_TAG:
            continue
        mem = tag_footprint_mb(tag, reg)
        if mem is None:
            continue
        chain = affinity_chain(tag, script)
        group = [(tag, mem)]
        group_known = True
        for a in chain[1:]:
            am = tag_footprint_mb(a, reg)
            if am is None:
                group_known = False
                continue
            group.append((a, am))

        chains = {t: resolved[t].blocks if t in resolved
                  else resolved[DEFAULT_TAG].blocks for t, _m in group}

        # ---- placement: the chain must be schedulable at all -------------- #
        verdict = _placeable(group, shapes, chains, config)
        if verdict is False:
            caps = sorted({s.memory_mb for s in shapes}, reverse=True)
            diags.append(Diagnostic(
                SEVERITY_ERROR, tag,
                f"chain {'->'.join(t for t, _m in group)} "
                f"({'+'.join(f'{m:g}' for _t, m in group)} MB) cannot be "
                "placed on this cluster under its affinity/anti-affinity/"
                f"zone/memory constraints (worker capacities: "
                f"{', '.join(f'{c:g}' for c in caps)} MB)",
                code=CODE_UNPLACEABLE))
            continue  # colocation question is moot

        # ---- warm co-residency under the keep-alive budget ---------------- #
        affine_blocks = [b for b in p.blocks if b.affinity.affine]
        if not affine_blocks or len(group) < 2 or not group_known:
            continue
        anchors_mb = sum(m for _t, m in group[1:])
        anchor_tags = [t for t, _m in group[1:]]
        # a worker usable for colocation must admit the tag through an
        # affinity-bearing block and every anchor through any block
        host_caps: List[float] = []
        for wi, w in enumerate(shapes):
            ok = any(
                (b.is_wildcard or w.name in b.workers)
                and b.affinity.admits_zone(w.zone)
                for b in affine_blocks)
            for a in anchor_tags:
                ok = ok and bool(_admissible_blocks(chains[a], w))
            if ok:
                host_caps.append(w.memory_mb)
        if not host_caps:
            continue  # placement already vouched for the fallback path
        cap_mem = max(host_caps)
        cap_eff = cap_mem if budget_mb is None else min(cap_mem, budget_mb)
        k_max = int((cap_eff - anchors_mb) // mem) if cap_eff > anchors_mb \
            else 0
        bound = max(1, config.concurrency_bound)
        if k_max >= bound:
            continue
        k = k_max + 1
        need = anchors_mb + k * mem
        if budget_mb is not None and budget_mb < cap_mem:
            binding, limit = "keep-alive budget", budget_mb
        else:
            binding, limit = "worker memory", cap_mem
        diags.append(Diagnostic(
            SEVERITY_WARNING, tag,
            f"co-locating {k}x '{tag}' ({mem:g} MB) with "
            f"{'+'.join(anchor_tags)} ({anchors_mb:g} MB) needs {need:g} MB "
            f"but the binding constraint is {binding} = {limit:g} MB — warm "
            f"co-residency is capped at {k_max}x, so the affinity terms "
            "degrade into a cold-start floor at this fan-out",
            code=CODE_BUDGET_COLOCATION))
    return tuple(diags)
