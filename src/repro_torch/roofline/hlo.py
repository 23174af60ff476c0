"""Post-SPMD HLO inspection: collective traffic + op census.

Shapes printed in partitioned HLO are per-device, so every byte count below is
per-chip.  Link traffic uses ring-algorithm formulas per collective kind:

  all-reduce       2 * B * (s-1)/s      (reduce-scatter + all-gather phases)
  all-gather       B_full * (s-1)/s     (result is the gathered buffer)
  reduce-scatter   B_full * (s-1)/s     (operand is the full buffer = result*s)
  all-to-all       B * (s-1)/s
  collective-permute  B

where s is the replica-group size parsed from ``replica_groups=[g,s]<=[...]``.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Optional, Tuple

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_OP_RE = re.compile(
    r"=\s*(?:\(([^)]*)\)|(\w+\[[\d,]*\](?:\{[^}]*\})?))\s+"
    r"(all-reduce(?:-start)?|all-gather(?:-start)?|reduce-scatter|"
    r"all-to-all|collective-permute(?:-start)?|collective-broadcast)\("
)
_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{([^}]*)\}")


def shape_bytes(s: str) -> int:
    """'bf16[2,1024]' -> bytes."""
    m = _SHAPE_RE.match(s.strip())
    if not m:
        return 0
    dt, dims = m.groups()
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES.get(dt, 4)


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    result_bytes: int
    group_size: int
    line: str

    @property
    def link_bytes(self) -> float:
        s = max(self.group_size, 1)
        frac = (s - 1) / s if s > 1 else 0.0
        B = self.result_bytes
        if self.kind.startswith("all-reduce"):
            return 2.0 * B * frac
        if self.kind.startswith("all-gather"):
            return B * frac  # result is the full gathered buffer
        if self.kind == "reduce-scatter":
            return B * s * frac  # operand = result * s
        if self.kind == "all-to-all":
            return B * frac
        if self.kind.startswith("collective-permute"):
            return float(B)
        if self.kind == "collective-broadcast":
            return float(B)
        return float(B)


def _group_size(line: str) -> int:
    m = _GROUPS_RE.search(line)
    if m:
        return int(m.group(2))
    m = _GROUPS_LIST_RE.search(line)
    if m:
        first = m.group(1).split("}")[0].split("{")[-1]
        ids = [x for x in first.split(",") if x.strip() != ""]
        return max(len(ids), 1)
    return 1


# --------------------------------------------------------------------------- #
# loop-aware module analysis
# --------------------------------------------------------------------------- #

_HEADER_RE = re.compile(r"^\s*(ENTRY\s+)?%?([\w.\-]+)\s*\((.*)\)\s*->\s*(.+?)\s*\{\s*$")
_WHILE_RE = re.compile(r"\bwhile\(.*?condition=%?([\w.\-]+), body=%?([\w.\-]+)")
_CALL_RE = re.compile(r"(?:calls|to_apply)=%?([\w.\-]+)")
_BRANCH_RE = re.compile(r"branch_computations=\{([^}]*)\}")
_S32_CONST_RE = re.compile(r"=\s*s32\[\]\s*constant\((\d+)\)")


def _parse_blocks(hlo_text: str) -> Tuple[Dict[str, List[str]], Optional[str]]:
    blocks: Dict[str, List[str]] = {}
    entry = None
    cur = None
    for line in hlo_text.splitlines():
        m = _HEADER_RE.match(line)
        if m:
            cur = m.group(2)
            blocks[cur] = []
            if m.group(1):
                entry = cur
            continue
        if line.strip() == "}":
            cur = None
            continue
        if cur is not None:
            blocks[cur].append(line)
    return blocks, entry


def _trip_count(cond_lines: List[str]) -> int:
    consts = []
    for l in cond_lines:
        consts += [int(x) for x in _S32_CONST_RE.findall(l)]
    return max(consts) if consts else 1


def computation_multiplicities(hlo_text: str) -> Dict[str, float]:
    """How many times each computation executes per step (while-loop aware)."""
    blocks, entry = _parse_blocks(hlo_text)
    if entry is None:
        entry = next(iter(blocks), None)
    edges: Dict[str, List[Tuple[str, float]]] = {b: [] for b in blocks}
    for name, lines in blocks.items():
        for line in lines:
            wm = _WHILE_RE.search(line)
            if wm:
                cond, body = wm.groups()
                trip = _trip_count(blocks.get(cond, []))
                edges[name].append((body, float(trip)))
                edges[name].append((cond, float(trip + 1)))
                continue
            bm = _BRANCH_RE.search(line)
            if bm:
                for b in bm.group(1).split(","):
                    b = b.strip().lstrip("%")
                    if b in blocks:
                        edges[name].append((b, 1.0))
            for cm in _CALL_RE.finditer(line):
                callee = cm.group(1)
                if callee in blocks:
                    edges[name].append((callee, 1.0))

    mult: Dict[str, float] = {b: 0.0 for b in blocks}
    if entry is None:
        return mult
    mult[entry] = 1.0
    # propagate along the DAG (HLO computations cannot recurse)
    import collections
    indeg = collections.Counter()
    for src, outs in edges.items():
        for dst, _ in outs:
            indeg[dst] += 1
    queue = collections.deque([b for b in blocks if indeg[b] == 0])
    seen = set()
    order = []
    while queue:
        b = queue.popleft()
        order.append(b)
        for dst, _ in edges[b]:
            indeg[dst] -= 1
            if indeg[dst] == 0:
                queue.append(dst)
    for b in order:
        for dst, w in edges[b]:
            mult[dst] += mult[b] * w
    return mult


def parse_collectives_weighted(hlo_text: str) -> List[Tuple[CollectiveOp, float]]:
    """Collectives with their per-step execution multiplicity."""
    blocks, entry = _parse_blocks(hlo_text)
    mult = computation_multiplicities(hlo_text)
    out: List[Tuple[CollectiveOp, float]] = []
    for name, lines in blocks.items():
        m = mult.get(name, 0.0)
        if m <= 0:
            continue
        for line in lines:
            if "-done" in line:
                continue
            om = _OP_RE.search(line)
            if not om:
                continue
            tuple_shapes, single_shape, kind = om.groups()
            if single_shape is not None:
                rb = shape_bytes(single_shape)
            else:
                rb = sum(shape_bytes(p) for p in tuple_shapes.split(","))
            out.append((CollectiveOp(kind=kind, result_bytes=rb,
                                     group_size=_group_size(line),
                                     line=line.strip()[:160]), m))
    return out


def parse_collectives(hlo_text: str) -> List[CollectiveOp]:
    out: List[CollectiveOp] = []
    for line in hlo_text.splitlines():
        if "-done" in line:
            continue  # async completion: counted at -start
        m = _OP_RE.search(line)
        if not m:
            continue
        tuple_shapes, single_shape, kind = m.groups()
        if single_shape is not None:
            rb = shape_bytes(single_shape)
        else:
            rb = sum(shape_bytes(p) for p in tuple_shapes.split(","))
        out.append(CollectiveOp(kind=kind, result_bytes=rb,
                                group_size=_group_size(line), line=line.strip()[:160]))
    return out


def collective_summary(hlo_text: str, *, loop_aware: bool = True) -> Dict[str, Dict[str, float]]:
    """kind -> {count, result_bytes, link_bytes} per device per step.

    ``loop_aware`` scales ops inside while-loop bodies (lax.scan over layer
    groups / chunks) by their trip counts."""
    summary: Dict[str, Dict[str, float]] = {}
    if loop_aware:
        items = parse_collectives_weighted(hlo_text)
    else:
        items = [(op, 1.0) for op in parse_collectives(hlo_text)]
    for op, m in items:
        k = op.kind.replace("-start", "")
        e = summary.setdefault(k, {"count": 0.0, "result_bytes": 0.0, "link_bytes": 0.0})
        e["count"] += m
        e["result_bytes"] += op.result_bytes * m
        e["link_bytes"] += op.link_bytes * m
    return summary


def total_link_bytes(hlo_text: str, *, loop_aware: bool = True) -> float:
    return sum(e["link_bytes"] for e in collective_summary(hlo_text, loop_aware=loop_aware).values())
