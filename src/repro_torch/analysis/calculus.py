"""The cost calculus: per-tag and per-chain worst-case cost derivation.

Grounded in *Serverless Scheduling Policies based on Cost Analysis* (arXiv
2310.20391): a tag's cost decomposes into a **lifecycle** term (the boot
charge of the container state the request finds — the warm pool's
cold/warm/hot :class:`~repro.pool.pool.StartCosts`) and a **service** term
(the function's execution time, from a pluggable oracle —
:mod:`repro.analysis.oracle`).  The *worst case* per tag takes the maximum
footprint and service time over the registry's functions carrying the tag:

* ``cold_s = lifecycle.cold + service_s``  (no container anywhere)
* ``warm_s = lifecycle.warm + service_s``  (a paused container exists)

A tag's **chain** is itself plus its transitive affinity anchors (the tags
its author blocks are affine to — divide-et-impera's ``i -> d``): the
chain's worst-case cost is the sum over members of the per-tag worst case,
the static bound on one end-to-end divide-et-impera request.  ``cost:``
annotations check the *cold*-path chain bound against ``budget_s``
(``over-budget`` warnings) and price invocations at ``rate_per_gb_s``
(``usd_per_invoke = GB x (boot + service) x rate``, reported only).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.ast import AAppScript
from repro_torch.core.compile import (
    Diagnostic,
    ResolvedPolicy,
    SEVERITY_WARNING,
)
from repro_torch.core.state import Registry

from .diagnostics import CODE_OVER_BUDGET
from .oracle import ServiceOracle


@dataclasses.dataclass(frozen=True)
class LifecycleCosts:
    """Boot/transfer charges in seconds.  Defaults mirror the warm pool's
    :class:`~repro.pool.pool.StartCosts` (and the cold-start benchmark's
    migrate charge), so an unconfigured analysis prices lifecycle the same
    way the simulator charges it."""

    cold: float = 0.5
    warm: float = 0.1
    hot: float = 0.0
    migrate: float = 0.25


@dataclasses.dataclass(frozen=True)
class AnalysisConfig:
    """Knobs of the two analysis passes.

    ``concurrency_bound`` is the fan-out the reachability pass proves
    co-location for (2 = the chained scenario's impera-per-divide);
    ``default_service_s`` covers functions the oracle does not know;
    ``max_states`` bounds the configuration-space search — an exhausted
    search stays silent (no diagnostic is ever emitted unproven)."""

    lifecycle: LifecycleCosts = LifecycleCosts()
    concurrency_bound: int = 2
    default_service_s: float = 0.0
    max_states: int = 50000


@dataclasses.dataclass(frozen=True)
class TagCost:
    """One tag's derived worst-case cost row (the report's table)."""

    tag: str
    footprint_mb: Optional[float]  # max registry footprint; None if no fn
    service_s: float
    cold_s: float
    warm_s: float
    chain: Tuple[str, ...]  # tag + transitive affinity anchors
    chain_cold_s: float
    chain_warm_s: float
    budget_s: Optional[float]  # tightest block budget, None when unannotated
    rate_per_gb_s: Optional[float]
    usd_per_invoke: Optional[float]


def tag_footprint_mb(tag: str, reg: Registry) -> Optional[float]:
    """Worst-case memory of a tag: max over registered functions carrying
    it (``None`` when the registry knows no such function)."""
    mems = [reg[n].memory for n in reg.names() if reg[n].tag == tag]
    return max(mems) if mems else None


def tag_service_s(tag: str, reg: Registry, oracle: Optional[ServiceOracle],
                  config: AnalysisConfig) -> float:
    """Worst-case service seconds of a tag: max over its functions of the
    oracle's answer, falling back to ``default_service_s`` per unknown."""
    names = [n for n in reg.names() if reg[n].tag == tag]
    if not names:
        return config.default_service_s
    out = config.default_service_s
    for n in names:
        s = oracle.service_s(n) if oracle is not None else None
        out = max(out, s if s is not None else config.default_service_s)
    return out


def affinity_chain(tag: str, script: AAppScript) -> Tuple[str, ...]:
    """``tag`` plus its transitive affinity anchors, discovery order.

    Anchors are the tags the author blocks' affine terms reference,
    followed transitively (divide-et-impera: ``i -> (i, d)``; a ``d`` that
    is itself affine to ``h`` yields ``i -> (i, d, h)``).  Anti-affine and
    zone terms never anchor.  Deterministic: blocks in author order, terms
    in clause order, each tag once."""
    chain: List[str] = [tag]
    frontier = [tag]
    while frontier:
        t = frontier.pop(0)
        policy = script.get(t)
        if policy is None:
            continue
        for b in policy.blocks:
            for a in b.affinity.affine:
                if a not in chain:
                    chain.append(a)
                    frontier.append(a)
    return tuple(chain)


def cost_pass(
    script: AAppScript,
    resolved: Dict[str, ResolvedPolicy],
    reg: Registry,
    config: AnalysisConfig,
    oracle: Optional[ServiceOracle] = None,
) -> Tuple[Tuple[TagCost, ...], Tuple[Diagnostic, ...]]:
    """Derive every author tag's cost row and check ``cost:`` budgets.

    Scripts without ``cost:`` annotations produce rows but zero
    diagnostics — the back-compat contract of the v4 bump."""
    life = config.lifecycle
    rows: List[TagCost] = []
    diags: List[Diagnostic] = []

    # memoised per-tag primitives (chains revisit members)
    service: Dict[str, float] = {}
    cold: Dict[str, float] = {}
    warm: Dict[str, float] = {}

    def primitives(tag: str) -> Tuple[float, float, float]:
        if tag not in service:
            s = tag_service_s(tag, reg, oracle, config)
            service[tag] = s
            cold[tag] = life.cold + s
            warm[tag] = life.warm + s
        return service[tag], cold[tag], warm[tag]

    for p in script.policies:
        s, c, w = primitives(p.tag)
        chain = affinity_chain(p.tag, script)
        chain_cold = sum(primitives(t)[1] for t in chain)
        chain_warm = sum(primitives(t)[2] for t in chain)
        footprint = tag_footprint_mb(p.tag, reg)

        budget: Optional[float] = None
        rate: Optional[float] = None
        for bi, b in enumerate(p.blocks):
            if b.cost is None:
                continue
            if b.cost.budget_s is not None:
                budget = (b.cost.budget_s if budget is None
                          else min(budget, b.cost.budget_s))
                if chain_cold > b.cost.budget_s:
                    over = chain_cold - b.cost.budget_s
                    diags.append(Diagnostic(
                        SEVERITY_WARNING, p.tag,
                        f"worst-case cold chain cost {chain_cold:.3f}s "
                        f"exceeds budget {b.cost.budget_s:g}s by {over:.3f}s "
                        f"(chain {'->'.join(chain)}: cold boot "
                        f"{life.cold:g}s/hop + worst service "
                        f"{'+'.join(f'{service[t]:g}' for t in chain)}s)",
                        code=CODE_OVER_BUDGET, block=bi))
            if b.cost.rate_per_gb_s is not None and rate is None:
                rate = b.cost.rate_per_gb_s

        usd: Optional[float] = None
        if rate is not None and footprint is not None:
            usd = (footprint / 1024.0) * c * rate
        rows.append(TagCost(
            tag=p.tag, footprint_mb=footprint, service_s=s, cold_s=c,
            warm_s=w, chain=chain, chain_cold_s=chain_cold,
            chain_warm_s=chain_warm, budget_s=budget, rate_per_gb_s=rate,
            usd_per_invoke=usd))
    return tuple(rows), tuple(diags)
