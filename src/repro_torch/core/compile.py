"""The aAPP v2 compile pipeline: **parse → resolve → validate → lower**.

The seed code conflated these stages: the parser did ad-hoc linting, the
scalar scheduler re-derived candidate-block chains on every call, and the
batched layer lowered policies to tensors on first touch.  This module makes
the pipeline explicit and gives it a versioned product — the
:class:`CompiledScript` IR — that every consumer shares (the
:class:`~repro.core.batched.SchedulerSession` adopts its tag universe and
row banks; the forecast planner walks its resolved block chains; the
:class:`repro.platform.Platform` facade caches it and hot-swaps it on
``reload_script``).  Future language growth (zones, soft affinity,
cost-derived policies) lands as a pass here instead of a cross-cutting
rewrite.

Stages
======

1. **parse** — aAPP source text → :class:`~repro.core.ast.AAppScript`
   (:func:`repro.core.parser.parse`; already-parsed ASTs pass through).
2. **resolve** — apply the followup/default chaining rule once per tag:
   each tag's candidate-block chain is its own blocks plus — unless
   ``followup: fail`` — the ``default`` tag's blocks (synthesised per APP
   semantics when absent).  This is Listing 1 lines 3-5 hoisted to compile
   time; :func:`repro.core.scheduler.candidate_blocks` is the same rule
   applied lazily.
3. **validate** — static semantic checks over the resolved script.  Errors
   raise :class:`CompileError` (an :class:`~repro.core.ast.AAppError`);
   warnings — unreachable blocks shadowed by an unconstrained wildcard
   block, affinity terms that reference no known tag — are collected as
   :class:`Diagnostic`\\ s on the result.
4. **lower** — compile every resolved chain to the numeric row banks the
   vectorized data plane evaluates (shared append-only
   :class:`~repro.core.batched.TagIndex` + per-tag
   :class:`~repro.core.batched.TagRows`), eagerly, so a compiled script is
   ready for its first decision with no lazy compilation hiccup.

``IR_VERSION`` stamps the product; consumers that persist or exchange
compiled scripts can reject stale IR after a lowering-format change.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np

from .ast import (
    AAppError,
    AAppScript,
    Block,
    DEFAULT_TAG,
    FOLLOWUP_FAIL,
    TagPolicy,
    default_policy,
)
from .batched import CompiledPolicies, TagIndex
from .parser import parse as _parse_text
from .state import Registry

# v1 = the seed's implicit (script, lazy rows) pairing; v2 = the explicit
# pipeline with resolved chains + eager row banks; v3 adds the topology
# terms (``zone:<z>`` / ``!zone:<z>`` + per-block ``topology:`` hints) and
# the zone lowering pass (:func:`zone_plan`: per-shard row banks + the
# zone-candidate mask consumed by the sharded router); v4 adds the static
# analysis section (:mod:`repro.analysis`): per-block ``cost:`` annotations
# in the AST, the cost-calculus pass, the cluster-shape reachability pass
# (``compile_script(workers=...)``), coded/sorted diagnostics, and the
# ``analysis`` report on the product.  Consumers pinned to an older IR use
# :func:`require_ir` for a clear rejection.
IR_VERSION = 4

SEVERITY_ERROR = "error"
SEVERITY_WARNING = "warning"


class CompileError(AAppError):
    """Static error detected by the validate stage; carries diagnostics."""

    def __init__(self, diagnostics: Tuple["Diagnostic", ...]):
        self.diagnostics = diagnostics
        super().__init__("; ".join(d.message for d in diagnostics))


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    severity: str  # SEVERITY_ERROR | SEVERITY_WARNING
    tag: Optional[str]
    message: str
    #: machine-readable code (the analysis passes' vocabulary —
    #: ``over-budget`` | ``budget-bound-colocation`` | ``unplaceable-chain``
    #: | ``ir-version``); validate-stage diagnostics keep ""
    code: str = ""
    #: author block index the finding anchors to, when one exists
    block: Optional[int] = None

    def __str__(self) -> str:
        where = f" [tag {self.tag!r}]" if self.tag else ""
        what = f" {self.code}" if self.code else ""
        return f"{self.severity}{where}{what}: {self.message}"


_SEVERITY_RANK = {SEVERITY_ERROR: 0, SEVERITY_WARNING: 1}


def diagnostic_sort_key(d: "Diagnostic") -> Tuple:
    """(severity, tag, block index, code, message) — errors first, then
    tag/block/code/message lexicographically.  Total and input-order-free,
    so a diagnostics tuple (and any report rendered from it) is byte-stable
    across runs."""
    return (_SEVERITY_RANK.get(d.severity, 9), d.tag or "",
            -1 if d.block is None else d.block, d.code, d.message)


def sort_diagnostics(diags: Iterable["Diagnostic"]) -> Tuple["Diagnostic", ...]:
    return tuple(sorted(diags, key=diagnostic_sort_key))


@dataclasses.dataclass(frozen=True)
class ResolvedPolicy:
    """One tag's fully-resolved candidate-block chain (followup applied)."""

    tag: str
    blocks: Tuple[Block, ...]
    followup: str
    synthesized: bool = False  # the default policy, absent from the source


@dataclasses.dataclass
class CompiledScript:
    """The versioned IR: source + AST + resolved chains + lowered rows."""

    ir_version: int
    script: AAppScript
    source: Optional[str]  # original text (None for programmatic ASTs)
    resolved: Dict[str, ResolvedPolicy]  # tag -> chain; always has DEFAULT_TAG
    diagnostics: Tuple[Diagnostic, ...]  # warnings, sorted (errors raise)
    tag_index: TagIndex
    policies: CompiledPolicies  # lowered row banks over tag_index
    #: the v4 static-analysis section (:class:`repro.analysis.AnalysisReport`:
    #: per-tag cost rows + the analysis diagnostics); None only on products
    #: built by pre-v4 constructors
    analysis: "object" = None

    @property
    def warnings(self) -> Tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics
                     if d.severity == SEVERITY_WARNING)

    def candidate_blocks(self, tag: str) -> Tuple[Block, ...]:
        """The chain Listing 1 iterates for ``tag`` (unknown tags fall
        through to the default chain, APP semantics)."""
        got = self.resolved.get(tag)
        if got is None:
            got = self.resolved[DEFAULT_TAG]
        return got.blocks

    def to_yaml(self, *, stylised: bool = False) -> str:
        return self.script.to_yaml(stylised=stylised)


# --------------------------------------------------------------------------- #
# stages
# --------------------------------------------------------------------------- #


def parse_stage(source: Union[str, AAppScript]) -> Tuple[AAppScript, Optional[str]]:
    """Source text (or a pass-through AST) → ``(script, source_text)``."""
    if isinstance(source, AAppScript):
        return source, None
    if not isinstance(source, str):
        raise AAppError(
            f"compile_script expects aAPP text or an AAppScript, "
            f"got {type(source).__name__}")
    return _parse_text(source), source


def resolve(script: AAppScript) -> Dict[str, ResolvedPolicy]:
    """Apply followup/default chaining to every tag (Listing 1 lines 3-5)."""
    dp = default_policy(script)
    out: Dict[str, ResolvedPolicy] = {}
    for p in script.policies:
        blocks = p.blocks
        if p.tag != DEFAULT_TAG and p.followup != FOLLOWUP_FAIL:
            blocks = blocks + dp.blocks
        out[p.tag] = ResolvedPolicy(tag=p.tag, blocks=blocks,
                                    followup=p.followup)
    if DEFAULT_TAG not in out:
        out[DEFAULT_TAG] = ResolvedPolicy(
            tag=DEFAULT_TAG, blocks=dp.blocks, followup=dp.followup,
            synthesized=True)
    return out


def _unconstrained_wildcard(b: Block) -> bool:
    """A block no later block can outlive: every worker, no invalidate, no
    affinity terms.  If it yields no valid worker the only failed check was
    memory (line 19), which every block applies — so later blocks in the
    same chain can never yield a worker either."""
    inv = b.invalidate
    return (b.is_wildcard and b.affinity.empty
            and inv.capacity_used is None
            and inv.max_concurrent_invocations is None)


def validate(
    script: AAppScript,
    resolved: Dict[str, ResolvedPolicy],
    reg: Optional[Registry] = None,
    zones: Optional[Iterable[str]] = None,
) -> Tuple[Diagnostic, ...]:
    """Static semantic checks.  Returns warnings; raises
    :class:`CompileError` when any error-severity diagnostic is found.

    ``zones`` (optional) is the platform's configured zone set: zone terms
    referencing a zone outside it warn (``unknown zone``), exactly like
    affinity terms that match no known tag."""
    diags: List[Diagnostic] = []

    known_tags = set(script.tags)
    if reg is not None:
        known_tags |= set(reg.tags())
    known_zones = set(zones) if zones is not None else None

    for p in script.policies:
        for b in p.blocks:
            both = set(b.affinity.affine) & set(b.affinity.anti_affine)
            if both:
                diags.append(Diagnostic(
                    SEVERITY_ERROR, p.tag,
                    f"tags {sorted(both)} are both affine and anti-affine "
                    "in the same block (unsatisfiable)"))
            zboth = set(b.affinity.zones) & set(b.affinity.anti_zones)
            if zboth:
                diags.append(Diagnostic(
                    SEVERITY_ERROR, p.tag,
                    f"zones {sorted(zboth)} are both required and excluded "
                    "in the same block (zone-unsatisfiable)"))
            if len(set(b.affinity.zones)) > 1:
                diags.append(Diagnostic(
                    SEVERITY_ERROR, p.tag,
                    f"block requires zones {sorted(set(b.affinity.zones))} "
                    "simultaneously — a worker lives in exactly one zone "
                    "(zone-unsatisfiable)"))
            if known_zones is not None:
                for z in (*b.affinity.zones, *b.affinity.anti_zones):
                    if z not in known_zones:
                        diags.append(Diagnostic(
                            SEVERITY_WARNING, p.tag,
                            f"zone term {z!r} matches no configured zone "
                            f"(have: {sorted(known_zones)})"))
            if reg is not None:
                for t in (*b.affinity.affine, *b.affinity.anti_affine):
                    if t not in known_tags:
                        diags.append(Diagnostic(
                            SEVERITY_WARNING, p.tag,
                            f"affinity term {t!r} matches no policy tag and "
                            "no registered function tag (dynamic residency "
                            "tags are injected at runtime; a typo never is)"))

    # unreachable blocks: only author-written blocks are checked — an
    # unconstrained wildcard as a tag's *last* own block legitimately
    # shadows the appended default chain ("fall through to anything")
    for p in script.policies:
        for i, b in enumerate(p.blocks[:-1]):
            if _unconstrained_wildcard(b):
                diags.append(Diagnostic(
                    SEVERITY_WARNING, p.tag,
                    f"block {i} matches every worker unconditionally; the "
                    f"{len(p.blocks) - 1 - i} later block(s) of this tag "
                    "are unreachable"))
                break

    errors = tuple(d for d in diags if d.severity == SEVERITY_ERROR)
    if errors:
        raise CompileError(sort_diagnostics(errors))
    return tuple(diags)


def lower(
    script: AAppScript,
    reg: Registry,
    tag_index: Optional[TagIndex] = None,
) -> Tuple[TagIndex, CompiledPolicies]:
    """Compile every tag's chain to row banks over a shared tag universe.

    The universe seeds from the script's own tags + affinity terms only
    (``TagIndex.ensure_script``) — registry tags enter via state deltas, so
    long-lived sessions keep :meth:`SchedulerSession.compact` effective.
    Passing an existing ``tag_index`` lowers into a live session's universe
    (the ``reload_script`` path)."""
    tag_index = tag_index if tag_index is not None else TagIndex([])
    tag_index.ensure_script(script, reg)
    policies = CompiledPolicies(script, reg, tag_index=tag_index)
    for tag in (*script.tags, DEFAULT_TAG):  # eager: IR is decision-ready
        policies.rows_for(tag)
    return tag_index, policies


# --------------------------------------------------------------------------- #
# driver
# --------------------------------------------------------------------------- #


def compile_script(
    source: Union[str, AAppScript],
    reg: Registry,
    *,
    tag_index: Optional[TagIndex] = None,
    zones: Optional[Iterable[str]] = None,
    workers=None,
    budget_mb: Optional[float] = None,
    service_times=None,
    analysis=None,
) -> CompiledScript:
    """Run the full pipeline; returns the versioned :class:`CompiledScript`.

    Raises :class:`~repro.core.ast.AAppError` (parse) or
    :class:`CompileError` (validate/analysis) on static errors; warnings
    land in ``.diagnostics`` — sorted by (severity, tag, block) — without
    failing the compile.  ``zones`` (the platform's configured zone set,
    optional) enables the unknown-zone diagnostics.

    The v4 analysis section (:mod:`repro.analysis`) always runs the cost
    calculus (``cost:`` budgets against derived worst-case chain cost; a
    script with no annotations gains zero diagnostics) and, when
    ``workers`` supplies a concrete cluster shape, the static reachability
    pass: proven-unplaceable chains are ``unplaceable-chain`` *errors*
    (this compile raises), budget-bound warm co-residency —
    ``min(worker memory, budget_mb)`` cannot hold a tag's affinity group at
    the configured fan-out — is a ``budget-bound-colocation`` *warning*.
    ``service_times`` feeds the cost oracle (a mapping or a
    :class:`repro.analysis.ServiceOracle`); ``analysis`` overrides the
    :class:`repro.analysis.AnalysisConfig` knobs.
    """
    script, text = parse_stage(source)
    resolved = resolve(script)
    diagnostics = validate(script, resolved, reg, zones)
    # lazy import: repro.analysis imports this module for Diagnostic et al.
    from repro_torch.analysis import analyze
    report = analyze(script, reg, resolved=resolved, workers=workers,
                     budget_mb=budget_mb, service_times=service_times,
                     config=analysis)
    errors = report.errors
    if errors:
        raise CompileError(sort_diagnostics(errors))
    diagnostics = sort_diagnostics(diagnostics + report.diagnostics)
    tag_index, policies = lower(script, reg, tag_index)
    return CompiledScript(
        ir_version=IR_VERSION,
        script=script,
        source=text,
        resolved=resolved,
        diagnostics=diagnostics,
        tag_index=tag_index,
        policies=policies,
        analysis=report,
    )


def require_ir(compiled: CompiledScript, version: int = IR_VERSION
               ) -> CompiledScript:
    """Back-compat guard for consumers that persist or exchange compiled
    scripts pinned to a specific IR version: pass the product through, or
    raise a :class:`CompileError` naming both versions (code
    ``ir-version``) instead of letting a stale consumer misread the IR."""
    got = getattr(compiled, "ir_version", None)
    if got != version:
        raise CompileError((Diagnostic(
            SEVERITY_ERROR, None,
            f"compiled-script IR version mismatch: consumer requires "
            f"v{version}, product carries v{got} (v4 added the cost/"
            "reachability analysis section — recompile the source with "
            "repro_torch.core.compile_script)",
            code="ir-version"),))
    return compiled


# --------------------------------------------------------------------------- #
# zone lowering (the v3 topology pass)
# --------------------------------------------------------------------------- #

#: sentinel worker id used when a zone's filtered default chain is empty: it
#: can never match a real worker, so an (unroutable tag, zone) pair fails
#: instead of falling back to a synthesised any-worker default
_UNSATISFIABLE_WORKER = "__zone-unsatisfiable__"


@dataclasses.dataclass
class ZonePlan:
    """One script's zone lowering against a concrete zone list.

    Produced by :func:`zone_plan` and consumed by
    :class:`repro.core.sharded.ShardedSession`'s two-level router:

    * ``masks[tag]`` is the **zone-candidate mask** — a ``[B, Z]`` boolean
      (blocks of the tag's resolved chain x zones) marking which zones each
      block admits under its ``zone:``/``!zone:`` terms;
    * ``zone_scripts[z]`` is the **per-shard script** — every tag's chain
      filtered to the blocks admissible in ``z`` with the (now vacuous)
      zone terms stripped, ``followup: fail`` (the default chain is already
      appended by resolve), lowered by each shard into its own row banks;
    * ``zone_pos[tag][z]`` maps an original chain position to its row in the
      shard's filtered bank (-1 when the block is inadmissible there);
    * ``hints[tag]`` is the chain's first per-block ``topology:`` hint (the
      zone-selection strategy for the whole decision), ``None`` when unset.

    ``routed_tags`` lists the tags whose chain carries zone terms or hints;
    for every other tag the router must delegate to the flat session —
    that delegation is what makes the sharded control plane bit-identical
    to the flat one on zone-free scripts (property-tested).
    """

    zones: Tuple[str, ...]
    chains: Dict[str, Tuple[Block, ...]]
    masks: Dict[str, np.ndarray]  # tag -> [B, Z] bool
    zone_scripts: Dict[str, AAppScript]
    zone_pos: Dict[str, Dict[str, Tuple[int, ...]]]  # tag -> zone -> per-block row
    hints: Dict[str, Optional[str]]
    routed_tags: frozenset
    # router-side memo for deterministic (ctx-free) zone orderings,
    # keyed (tag, block index, origin zone) — plans are cached per script,
    # so the memo amortises the per-decision ordering to a dict hit
    order_cache: Dict[Tuple[str, int, Optional[str]], Tuple[str, ...]] = \
        dataclasses.field(default_factory=dict)

    def chain(self, tag: str) -> Tuple[Block, ...]:
        got = self.chains.get(tag)
        return got if got is not None else self.chains[DEFAULT_TAG]

    def routed(self, tag: str) -> bool:
        return (tag if tag in self.chains else DEFAULT_TAG) in self.routed_tags

    def mask(self, tag: str) -> np.ndarray:
        got = self.masks.get(tag)
        return got if got is not None else self.masks[DEFAULT_TAG]

    def hint(self, tag: str) -> Optional[str]:
        return self.hints.get(tag if tag in self.chains else DEFAULT_TAG)

    def pos(self, tag: str, zone: str, block_index: int) -> int:
        key = tag if tag in self.zone_pos else DEFAULT_TAG
        return self.zone_pos[key][zone][block_index]


def _strip_zone_terms(block: Block) -> Block:
    changed = {}
    if not block.affinity.zone_free:
        changed["affinity"] = block.affinity.strip_zones()
    if block.topology is not None:
        changed["topology"] = None  # consumed by the router, inert in-shard
    return dataclasses.replace(block, **changed) if changed else block


def zone_plan(script: AAppScript, zones: Iterable[str]) -> ZonePlan:
    """Lower a script's zone constraints against a concrete zone list.

    Pure function of (script, zones) — the sharded session caches it and
    recomputes only when the platform's zone set changes."""
    zones = tuple(dict.fromkeys(zones))
    resolved = resolve(script)
    zidx = {z: i for i, z in enumerate(zones)}

    chains: Dict[str, Tuple[Block, ...]] = {}
    masks: Dict[str, np.ndarray] = {}
    hints: Dict[str, Optional[str]] = {}
    routed: List[str] = []
    for tag, rp in resolved.items():
        chains[tag] = rp.blocks
        m = np.zeros((len(rp.blocks), len(zones)), bool)
        for bi, b in enumerate(rp.blocks):
            for z, zi in zidx.items():
                m[bi, zi] = b.affinity.admits_zone(z)
        masks[tag] = m
        hints[tag] = next((b.topology for b in rp.blocks
                           if b.topology is not None), None)
        if any(b.routed for b in rp.blocks):
            routed.append(tag)

    zone_scripts: Dict[str, AAppScript] = {}
    zone_pos: Dict[str, Dict[str, Tuple[int, ...]]] = {
        tag: {} for tag in chains}
    if not routed:
        # zone-free script: every decision delegates to the flat session,
        # so the per-zone lowering below would never be consulted — skip it
        # (serving engines synthesise a fresh script per request class; the
        # O(zones x tags x blocks) construction must not sit on that path)
        return ZonePlan(
            zones=zones, chains=chains, masks=masks,
            zone_scripts=zone_scripts, zone_pos=zone_pos, hints=hints,
            routed_tags=frozenset())
    for z, zi in zidx.items():
        policies: List[TagPolicy] = []
        for tag, blocks in chains.items():
            filtered: List[Block] = []
            pos: List[int] = []
            for bi, b in enumerate(blocks):
                if masks[tag][bi, zi]:
                    pos.append(len(filtered))
                    filtered.append(_strip_zone_terms(b))
                else:
                    pos.append(-1)
            zone_pos[tag][z] = tuple(pos)
            if filtered:
                policies.append(TagPolicy(tag=tag, blocks=tuple(filtered),
                                          followup=FOLLOWUP_FAIL))
            else:
                # every block of this tag excludes the zone: a poisoned chain
                # (a worker id that cannot exist) so a shard asked anyway
                # fails instead of inheriting a synthesised any-worker
                # default (the router normally skips such zones entirely)
                policies.append(TagPolicy(
                    tag=tag,
                    blocks=(Block(workers=(_UNSATISFIABLE_WORKER,)),),
                    followup=FOLLOWUP_FAIL))
        zone_scripts[z] = AAppScript(policies=tuple(policies))

    return ZonePlan(
        zones=zones,
        chains=chains,
        masks=masks,
        zone_scripts=zone_scripts,
        zone_pos=zone_pos,
        hints=hints,
        routed_tags=frozenset(routed),
    )
