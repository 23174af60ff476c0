"""aAPP parser: YAML text -> :class:`repro.core.ast.AAppScript`.

The paper (§III, footnote 1) notes aAPP scripts are YAML-compliant but the
presentation is "stylised" — e.g. ``workers: *`` and anti-affinity terms
``!h_tag`` are written unquoted, while plain YAML would read ``*`` as an alias
marker and ``!x`` as a type tag.  We therefore pre-process the stylised tokens
into quoted strings before handing the text to a standard YAML loader, so both
the paper's stylised scripts (Fig. 3, Fig. 5) and strictly-quoted YAML parse to
the same AST.

Accepted tag-policy shapes (all appear across the APP/aAPP papers):

* mapping  -> a single block, with an optional inline ``followup`` key;
* sequence -> one block per item; an item carrying only ``followup`` sets the
  tag's followup;
* mapping with explicit ``blocks:`` (+ optional ``followup:``).
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from .ast import (
    AAppError,
    AAppScript,
    Affinity,
    Block,
    CostSpec,
    Invalidate,
    TagPolicy,
    WILDCARD,
    FOLLOWUP_DEFAULT,
    FOLLOWUP_FAIL,
    STRATEGY_BEST_FIRST,
)
from .strategies import (
    known_strategy,
    known_zone_strategy,
    resolve_strategy_name,
    resolve_zone_strategy_name,
    strategy_names,
    zone_strategy_names,
)

# --------------------------------------------------------------------------- #
# stylised-YAML pre-processing
# --------------------------------------------------------------------------- #

# `!tag` after ':', '-', ',' or '[' -> '"!tag"'; the optional `:suffix`
# covers the v2 topology terms (`!zone:eu`), which would otherwise be cut at
# the colon and re-read as a YAML mapping key
_BANG = re.compile(r"(?P<lead>[:\-,\[]\s*)!(?P<name>[A-Za-z_][\w\-]*(?::[\w\-]+)?)")
# a bare `*` value (after ':' or '-') -> '"*"'
_STAR = re.compile(r"(?P<lead>[:\-]\s+)\*(?P<trail>\s*(?:#.*)?)$", re.MULTILINE)
_STAR_INLINE = re.compile(r"(?P<lead>[:,\[]\s*)\*(?P<trail>\s*[,\]])")


def _preprocess(text: str) -> str:
    text = _BANG.sub(lambda m: f'{m.group("lead")}"!{m.group("name")}"', text)
    text = _STAR.sub(lambda m: f'{m.group("lead")}"*"{m.group("trail")}', text)
    text = _STAR_INLINE.sub(lambda m: f'{m.group("lead")}"*"{m.group("trail")}', text)
    return text


# --------------------------------------------------------------------------- #
# clause parsing
# --------------------------------------------------------------------------- #


def _as_str_list(value: Any, *, clause: str) -> List[str]:
    if value is None:
        raise AAppError(f"{clause}: empty value")
    if isinstance(value, str):
        items = [v.strip() for v in value.split(",")]
    elif isinstance(value, (list, tuple)):
        items = []
        for v in value:
            if not isinstance(v, (str, int, float)):
                raise AAppError(f"{clause}: unexpected item {v!r}")
            items.append(str(v).strip())
    else:
        raise AAppError(f"{clause}: expected string or list, got {type(value).__name__}")
    # inline comma-separated plain scalars keep the pre-processor's literal
    # quotes around "!tag" terms — strip matching surrounding quotes
    def unquote(s: str) -> str:
        if len(s) >= 2 and s[0] == s[-1] and s[0] in "\"'":
            return s[1:-1].strip()
        return s

    items = [unquote(i) for i in items if i]
    items = [i for i in items if i]
    if not items:
        raise AAppError(f"{clause}: empty list")
    return items


def _parse_workers(value: Any) -> Tuple[str, ...]:
    items = _as_str_list(value, clause="workers")
    return tuple(items)


_CAP_RE = re.compile(r"^capacity_used\s+(?P<n>\d+(?:\.\d+)?)\s*%?$")
_MCI_RE = re.compile(r"^max_concurrent_invocations\s+(?P<n>\d+)$")


def _parse_invalidate(value: Any) -> Invalidate:
    cap: Optional[float] = None
    mci: Optional[int] = None

    def eat(item: Any) -> None:
        nonlocal cap, mci
        if isinstance(item, dict):
            for k, v in item.items():
                eat(f"{k} {v}")
            return
        if not isinstance(item, str):
            raise AAppError(f"invalidate: unexpected item {item!r}")
        s = item.strip()
        m = _CAP_RE.match(s)
        if m:
            if cap is not None:
                raise AAppError("invalidate: duplicate capacity_used")
            cap = float(m.group("n"))
            return
        m = _MCI_RE.match(s)
        if m:
            if mci is not None:
                raise AAppError("invalidate: duplicate max_concurrent_invocations")
            mci = int(m.group("n"))
            return
        raise AAppError(f"invalidate: cannot parse option {s!r}")

    if isinstance(value, (list, tuple)):
        for item in value:
            eat(item)
    else:
        eat(value)
    return Invalidate(capacity_used=cap, max_concurrent_invocations=mci)


def _parse_affinity(value: Any) -> Affinity:
    return Affinity.from_terms(_as_str_list(value, clause="affinity"))


_NUM = r"\d+(?:\.\d+)?(?:[eE][+-]?\d+)?"
_BUDGET_RE = re.compile(rf"^budget\s+(?P<n>{_NUM})\s*s?$")
_RATE_RE = re.compile(rf"^rate\s+(?P<n>{_NUM})\s*(?:\$/GB-s)?$")


def _parse_cost(value: Any) -> CostSpec:
    budget: Optional[float] = None
    rate: Optional[float] = None

    def eat(item: Any) -> None:
        nonlocal budget, rate
        if isinstance(item, dict):
            for k, v in item.items():
                eat(f"{k} {v}")
            return
        if isinstance(item, (int, float)):
            raise AAppError(
                f"cost: bare number {item!r}; write 'budget {item}s' or "
                f"'rate {item} $/GB-s'")
        if not isinstance(item, str):
            raise AAppError(f"cost: unexpected item {item!r}")
        s = item.strip()
        m = _BUDGET_RE.match(s)
        if m:
            if budget is not None:
                raise AAppError("cost: duplicate budget")
            budget = float(m.group("n"))
            return
        m = _RATE_RE.match(s)
        if m:
            if rate is not None:
                raise AAppError("cost: duplicate rate")
            rate = float(m.group("n"))
            return
        raise AAppError(f"cost: cannot parse option {s!r}")

    if isinstance(value, (list, tuple)):
        for item in value:
            eat(item)
    else:
        eat(value)
    return CostSpec(budget_s=budget, rate_per_gb_s=rate)


_BLOCK_KEYS = {"workers", "strategy", "invalidate", "affinity", "topology",
               "cost"}


def _parse_block(obj: Any, *, tag: str) -> Block:
    if not isinstance(obj, dict):
        raise AAppError(f"tag {tag!r}: block must be a mapping, got {obj!r}")
    unknown = set(obj) - _BLOCK_KEYS
    if unknown:
        raise AAppError(f"tag {tag!r}: unknown block key(s) {sorted(unknown)}")
    if "workers" not in obj:
        raise AAppError(f"tag {tag!r}: block missing 'workers'")
    workers = _parse_workers(obj["workers"])
    strategy_raw = str(obj.get("strategy", STRATEGY_BEST_FIRST)).strip()
    if not known_strategy(strategy_raw):
        raise AAppError(
            f"tag {tag!r}: unknown strategy {strategy_raw!r}; registered: "
            f"{', '.join(strategy_names())}")
    strategy = resolve_strategy_name(strategy_raw)
    topology: Optional[str] = None
    if "topology" in obj:
        topology_raw = str(obj["topology"]).strip()
        if not known_zone_strategy(topology_raw):
            raise AAppError(
                f"tag {tag!r}: unknown topology strategy {topology_raw!r}; "
                f"registered: {', '.join(zone_strategy_names())}")
        topology = resolve_zone_strategy_name(topology_raw)
    invalidate = (
        _parse_invalidate(obj["invalidate"]) if "invalidate" in obj else Invalidate()
    )
    affinity = _parse_affinity(obj["affinity"]) if "affinity" in obj else Affinity()
    cost = _parse_cost(obj["cost"]) if "cost" in obj else None
    if cost is not None and cost.empty:
        raise AAppError(f"tag {tag!r}: empty cost clause")
    return Block(
        workers=workers, strategy=strategy, invalidate=invalidate,
        affinity=affinity, topology=topology, cost=cost,
    )


def _parse_followup(value: Any, *, tag: str) -> str:
    s = str(value).strip()
    if s not in (FOLLOWUP_DEFAULT, FOLLOWUP_FAIL):
        raise AAppError(f"tag {tag!r}: followup must be 'default'|'fail', got {s!r}")
    return s


def _parse_tag_policy(tag: str, value: Any) -> TagPolicy:
    followup = FOLLOWUP_DEFAULT
    blocks: List[Block] = []

    if isinstance(value, dict) and "blocks" in value:
        if set(value) - {"blocks", "followup"}:
            raise AAppError(f"tag {tag!r}: unexpected keys next to 'blocks'")
        if "followup" in value:
            followup = _parse_followup(value["followup"], tag=tag)
        items = value["blocks"]
        if not isinstance(items, (list, tuple)):
            raise AAppError(f"tag {tag!r}: 'blocks' must be a sequence")
        for item in items:
            blocks.append(_parse_block(item, tag=tag))
    elif isinstance(value, dict):
        body = dict(value)
        if "followup" in body:
            followup = _parse_followup(body.pop("followup"), tag=tag)
        blocks.append(_parse_block(body, tag=tag))
    elif isinstance(value, (list, tuple)):
        for item in value:
            if isinstance(item, dict) and set(item) == {"followup"}:
                followup = _parse_followup(item["followup"], tag=tag)
                continue
            if isinstance(item, dict) and "followup" in item and "workers" not in item:
                raise AAppError(f"tag {tag!r}: 'followup' mixed into a block item")
            blocks.append(_parse_block(item, tag=tag))
    else:
        raise AAppError(f"tag {tag!r}: policy must be a mapping or sequence")

    if not blocks:
        raise AAppError(f"tag {tag!r}: no blocks")
    return TagPolicy(tag=tag, blocks=tuple(blocks), followup=followup)


# --------------------------------------------------------------------------- #
# entry points
# --------------------------------------------------------------------------- #


def parse(text: str) -> AAppScript:
    """Parse aAPP source text into an :class:`AAppScript`."""
    # PyYAML is needed only to read source text: importing the port (and
    # building scripts from the AST classes) works without it
    import yaml

    try:
        doc = yaml.safe_load(_preprocess(text))
    except yaml.YAMLError as e:  # pragma: no cover - message passthrough
        raise AAppError(f"invalid YAML: {e}") from e
    if doc is None:
        raise AAppError("empty aAPP script")
    if not isinstance(doc, dict):
        raise AAppError("top level of an aAPP script must map tags to policies")
    policies = []
    for tag, value in doc.items():
        if not isinstance(tag, str) or not tag:
            raise AAppError(f"invalid tag name {tag!r}")
        policies.append(_parse_tag_policy(tag, value))
    script = AAppScript(policies=tuple(policies))
    _lint(script)
    return script


def parse_file(path: str) -> AAppScript:
    with open(path, "r") as f:
        return parse(f.read())


def _lint(script: AAppScript) -> None:
    """Static sanity checks (non-fatal issues raise only when nonsensical)."""
    for tag, refs in script.referenced_tags().items():
        policy = script[tag]
        for b in policy.blocks:
            both = set(b.affinity.affine) & set(b.affinity.anti_affine)
            if both:
                raise AAppError(
                    f"tag {tag!r}: tags {sorted(both)} are both affine and "
                    "anti-affine in the same block (unsatisfiable)"
                )
            zboth = set(b.affinity.zones) & set(b.affinity.anti_zones)
            if zboth:
                raise AAppError(
                    f"tag {tag!r}: zones {sorted(zboth)} are both required "
                    "and excluded in the same block (zone-unsatisfiable)"
                )
            if len(set(b.affinity.zones)) > 1:
                raise AAppError(
                    f"tag {tag!r}: block requires "
                    f"{sorted(set(b.affinity.zones))} simultaneously — a "
                    "worker lives in exactly one zone (zone-unsatisfiable)"
                )


def to_text(script: AAppScript, *, stylised: bool = False) -> str:
    """Serialise back to YAML — round-trips through parse().

    ``stylised=False`` (default) emits strict, quoted YAML; ``stylised=True``
    emits the paper's presentation (bare ``workers: *`` and ``!tag``
    anti-affinity terms), which the pre-processor re-quotes on parse — so
    both forms satisfy ``parse(to_text(s, ...)) == s``.
    """
    star = "*" if stylised else '"*"'
    bang = (lambda t: f"!{t}") if stylised else (lambda t: f'"!{t}"')
    lines: List[str] = []
    for p in script.policies:
        lines.append(f"{p.tag}:")
        for b in p.blocks:
            first = "  - "
            cont = "    "
            if b.is_wildcard:
                lines.append(f"{first}workers: {star}")
            else:
                lines.append(f"{first}workers:")
                for w in b.workers:
                    lines.append(f"{cont}  - {w}")
            lines.append(f"{cont}strategy: {b.strategy}")
            if b.topology is not None:
                lines.append(f"{cont}topology: {b.topology}")
            inv = b.invalidate
            if inv.capacity_used is not None or inv.max_concurrent_invocations is not None:
                lines.append(f"{cont}invalidate:")
                if inv.capacity_used is not None:
                    cap = inv.capacity_used
                    cap_s = f"{int(cap)}" if float(cap).is_integer() else f"{cap}"
                    lines.append(f"{cont}  - capacity_used {cap_s}%")
                if inv.max_concurrent_invocations is not None:
                    lines.append(
                        f"{cont}  - max_concurrent_invocations "
                        f"{inv.max_concurrent_invocations}"
                    )
            if b.cost is not None and not b.cost.empty:
                # repr() round-trips floats exactly: parse(to_text(s)) == s
                lines.append(f"{cont}cost:")
                if b.cost.budget_s is not None:
                    lines.append(f"{cont}  - budget {b.cost.budget_s!r}s")
                if b.cost.rate_per_gb_s is not None:
                    lines.append(
                        f"{cont}  - rate {b.cost.rate_per_gb_s!r} $/GB-s")
            if not b.affinity.empty:
                lines.append(f"{cont}affinity:")
                for t in b.affinity.affine:
                    lines.append(f"{cont}  - {t}")
                for z in b.affinity.zones:
                    lines.append(f"{cont}  - zone:{z}")
                for t in b.affinity.anti_affine:
                    lines.append(f"{cont}  - {bang(t)}")
                for z in b.affinity.anti_zones:
                    lines.append(f"{cont}  - {bang('zone:' + z)}")
        if p.followup != FOLLOWUP_DEFAULT:
            lines.append(f"  - followup: {p.followup}")
    return "\n".join(lines) + "\n"
