"""aAPP abstract syntax (Fig. 2 of the paper).

An aAPP script is an ordered map ``tag -> TagPolicy``.  Each ``TagPolicy`` is an
ordered list of ``Block``s plus an optional ``followup`` (``default`` | ``fail``,
default ``default``).  Each ``Block`` selects candidate ``workers`` (explicit ids
or the wildcard ``*``), a ``strategy`` (any name in the pluggable
:mod:`repro.core.strategies` registry — the paper's ``best_first`` | ``any``
(alias ``random``) plus ``least_loaded`` and ``warmest``), ``invalidate``
options (``capacity_used n%`` | ``max_concurrent_invocations n``), the novel
``affinity`` clause: a list of tag ids (affine) and ``!``-negated tag ids
(anti-affine) — affinity is *directional* (footnote 2), no symmetry is imposed —
and, since IR v4, an optional ``cost:`` clause (``budget <s>s`` |
``rate <r> $/GB-s``) consumed by the compile-time cost calculus
(:mod:`repro.analysis`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from .strategies import (
    known_strategy,
    known_zone_strategy,
    resolve_strategy_name,
    resolve_zone_strategy_name,
    strategy_names,
    zone_strategy_names,
)

WILDCARD = "*"
DEFAULT_TAG = "default"

#: affinity terms of the form ``zone:<name>`` / ``!zone:<name>`` constrain the
#: candidate worker's *zone* (topology membership) instead of its resident tags
ZONE_PREFIX = "zone:"

STRATEGY_BEST_FIRST = "best_first"
STRATEGY_ANY = "any"

FOLLOWUP_DEFAULT = "default"
FOLLOWUP_FAIL = "fail"


class AAppError(Exception):
    """Static (parse/validation) error in an aAPP script."""


class SchedulingFailure(Exception):
    """Raised when no valid worker exists (Listing 1, line 15)."""


@dataclasses.dataclass(frozen=True)
class Invalidate:
    """Invalidate options of a block.

    ``capacity_used`` is a percentage threshold in (0, 100]: a worker is invalid
    once its memory occupation reaches the threshold (paper §III: "invalidates a
    worker if its resource occupation reaches the set threshold").
    ``max_concurrent_invocations`` invalidates a worker that already hosts >= n
    functions.
    """

    capacity_used: Optional[float] = None
    max_concurrent_invocations: Optional[int] = None

    def __post_init__(self):
        if self.capacity_used is not None and not (0 < self.capacity_used <= 100):
            raise AAppError(
                f"capacity_used must be a percentage in (0, 100], got {self.capacity_used}"
            )
        if (
            self.max_concurrent_invocations is not None
            and self.max_concurrent_invocations < 1
        ):
            raise AAppError(
                "max_concurrent_invocations must be >= 1, got "
                f"{self.max_concurrent_invocations}"
            )


@dataclasses.dataclass(frozen=True)
class CostSpec:
    """The optional ``cost:`` clause of a block (the v4 cost calculus).

    ``budget_s`` is a worst-case end-to-end latency budget in seconds for the
    tag's *chain* (the tag plus its transitive affinity anchors): the compile
    pipeline's cost pass derives the chain's worst-case cold-path cost and
    attaches an ``over-budget`` diagnostic when the derivation exceeds it.
    ``rate_per_gb_s`` is a $/GB-s price the pass uses to derive per-invocation
    dollar cost (reported, never diagnosed — a rate is not a bound).
    """

    budget_s: Optional[float] = None
    rate_per_gb_s: Optional[float] = None

    def __post_init__(self):
        if self.budget_s is not None and not self.budget_s > 0:
            raise AAppError(
                f"cost: budget must be > 0 seconds, got {self.budget_s}")
        if self.rate_per_gb_s is not None and self.rate_per_gb_s < 0:
            raise AAppError(
                f"cost: rate must be >= 0 $/GB-s, got {self.rate_per_gb_s}")

    @property
    def empty(self) -> bool:
        return self.budget_s is None and self.rate_per_gb_s is None


@dataclasses.dataclass(frozen=True)
class Affinity:
    """The affinity clause: affine tags, anti-affine tags (``!tag``), and the
    aAPP v2 topology terms — ``zone:<z>`` (the worker must live in zone ``z``)
    and ``!zone:<z>`` (the worker must not).  Zone terms constrain worker
    *placement*, not resident tags, and are stored separately so the tag
    machinery (occupancy tensors, pending-demand plumbing) never sees them."""

    affine: Tuple[str, ...] = ()
    anti_affine: Tuple[str, ...] = ()
    zones: Tuple[str, ...] = ()  # ``zone:<z>`` terms (worker zone must match)
    anti_zones: Tuple[str, ...] = ()  # ``!zone:<z>`` terms

    @staticmethod
    def from_terms(terms: Sequence[str]) -> "Affinity":
        affine, anti, zones, anti_zones = [], [], [], []
        for t in terms:
            t = t.strip()
            if not t:
                raise AAppError("empty affinity term")
            if t.startswith("!"):
                name = t[1:].strip()
                if not name:
                    raise AAppError("anti-affinity '!' with no tag")
                if name.startswith(ZONE_PREFIX):
                    zname = name[len(ZONE_PREFIX):].strip()
                    if not zname:
                        raise AAppError("'!zone:' with no zone name")
                    anti_zones.append(zname)
                else:
                    anti.append(name)
            elif t.startswith(ZONE_PREFIX):
                zname = t[len(ZONE_PREFIX):].strip()
                if not zname:
                    raise AAppError("'zone:' with no zone name")
                zones.append(zname)
            else:
                affine.append(t)
        return Affinity(affine=tuple(affine), anti_affine=tuple(anti),
                        zones=tuple(zones), anti_zones=tuple(anti_zones))

    @property
    def empty(self) -> bool:
        return (not self.affine and not self.anti_affine
                and not self.zones and not self.anti_zones)

    @property
    def zone_free(self) -> bool:
        return not self.zones and not self.anti_zones

    def strip_zones(self) -> "Affinity":
        """The same clause with the zone terms removed (per-shard lowering:
        a shard's blocks are admissible by construction)."""
        if self.zone_free:
            return self
        return Affinity(affine=self.affine, anti_affine=self.anti_affine)

    def admits_zone(self, zone: str) -> bool:
        """Whether a worker in ``zone`` can satisfy this clause's zone terms
        (the tag terms are a separate, runtime question)."""
        if self.zones and zone not in self.zones:
            return False
        if zone in self.anti_zones:
            return False
        return True


@dataclasses.dataclass(frozen=True)
class Block:
    workers: Tuple[str, ...]  # worker ids, or (WILDCARD,)
    strategy: str = STRATEGY_BEST_FIRST
    invalidate: Invalidate = dataclasses.field(default_factory=Invalidate)
    affinity: Affinity = dataclasses.field(default_factory=Affinity)
    #: optional zone-selection hint for the sharded router (``topology:``
    #: clause): any name in the pluggable zone-strategy registry —
    #: ``local_first`` | ``least_loaded_zone`` | ``warmest_zone``.  Inert on
    #: the flat (single-zone) control plane.
    topology: Optional[str] = None
    #: optional ``cost:`` annotation (latency budget / $-rate) consumed by
    #: the v4 compile-time cost calculus; inert at decision time
    cost: Optional[CostSpec] = None

    def __post_init__(self):
        if not self.workers:
            raise AAppError("block with empty workers list")
        if not known_strategy(self.strategy):
            raise AAppError(
                f"unknown strategy {self.strategy!r}; registered: "
                f"{', '.join(strategy_names())}")
        canonical = resolve_strategy_name(self.strategy)
        if canonical != self.strategy:  # normalise aliases (frozen dataclass)
            object.__setattr__(self, "strategy", canonical)
        if self.topology is not None:
            if not known_zone_strategy(self.topology):
                raise AAppError(
                    f"unknown topology strategy {self.topology!r}; "
                    f"registered: {', '.join(zone_strategy_names())}")
            canonical = resolve_zone_strategy_name(self.topology)
            if canonical != self.topology:
                object.__setattr__(self, "topology", canonical)
        if WILDCARD in self.workers and len(self.workers) > 1:
            raise AAppError("'*' cannot be mixed with explicit worker ids")

    @property
    def is_wildcard(self) -> bool:
        return self.workers == (WILDCARD,)

    @property
    def routed(self) -> bool:
        """Whether the sharded router must engage for this block: it carries
        zone terms or an explicit topology hint."""
        return self.topology is not None or not self.affinity.zone_free


@dataclasses.dataclass(frozen=True)
class TagPolicy:
    tag: str
    blocks: Tuple[Block, ...]
    followup: str = FOLLOWUP_DEFAULT

    def __post_init__(self):
        if not self.blocks:
            raise AAppError(f"tag {self.tag!r} has no blocks")
        if self.followup not in (FOLLOWUP_DEFAULT, FOLLOWUP_FAIL):
            raise AAppError(f"unknown followup {self.followup!r}")


@dataclasses.dataclass(frozen=True)
class AAppScript:
    """An ordered collection of tag policies."""

    policies: Tuple[TagPolicy, ...]

    def __post_init__(self):
        seen = set()
        for p in self.policies:
            if p.tag in seen:
                raise AAppError(f"duplicate tag {p.tag!r}")
            seen.add(p.tag)

    @property
    def tags(self) -> Tuple[str, ...]:
        return tuple(p.tag for p in self.policies)

    def __contains__(self, tag: str) -> bool:
        return any(p.tag == tag for p in self.policies)

    def __getitem__(self, tag: str) -> TagPolicy:
        for p in self.policies:
            if p.tag == tag:
                return p
        raise KeyError(tag)

    def get(self, tag: str) -> Optional[TagPolicy]:
        try:
            return self[tag]
        except KeyError:
            return None

    def to_yaml(self, *, stylised: bool = False) -> str:
        """Serialise back to aAPP source text.  ``stylised=False`` (default)
        emits strict, quoted YAML; ``stylised=True`` emits the paper's
        presentation (`workers: *`, bare ``!tag`` anti-affinity terms).
        Both round-trip: ``parse(s.to_yaml(...)) == s``."""
        from .parser import to_text  # local import: parser imports this module

        return to_text(self, stylised=stylised)

    def referenced_tags(self) -> Dict[str, List[str]]:
        """tag -> tags referenced in its affinity clauses (for validation)."""
        out: Dict[str, List[str]] = {}
        for p in self.policies:
            refs: List[str] = []
            for b in p.blocks:
                refs.extend(b.affinity.affine)
                refs.extend(b.affinity.anti_affine)
            out[p.tag] = refs
        return out


def default_policy(script: AAppScript) -> TagPolicy:
    """The special ``default`` policy; synthesised if absent (APP semantics:
    any worker, best_first, fail if exhausted)."""
    p = script.get(DEFAULT_TAG)
    if p is not None:
        return p
    return TagPolicy(
        tag=DEFAULT_TAG,
        blocks=(Block(workers=(WILDCARD,)),),
        followup=FOLLOWUP_FAIL,
    )
