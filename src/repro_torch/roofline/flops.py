"""Loop-aware HLO cost model.

XLA's ``compiled.cost_analysis()`` visits every computation once, so anything
inside a ``lax.scan`` while-body (i.e. *all* our layer compute) is counted a
single time.  This module re-derives per-step FLOPs and HBM bytes from the
partitioned HLO text with while-loop multiplicities:

* FLOPs: ``dot`` = 2 * prod(result) * contraction, elementwise/transcendental
  ops = prod(result) (inside fused computations too), ``reduce`` = prod(operand).
* Bytes: per *executable* op line, operand bytes + result bytes (fused
  computations are skipped — their traffic is the fusion call site's), which is
  the same accounting XLA's own 'bytes accessed' uses.

Validated against cost_analysis() on loop-free programs (ratio ~= 1.0) in
tests/test_roofline.py.

The port adds the same rules on PyTorch's aten op stream
(:class:`OpCounter`): eager PyTorch has no while loops, so each executed op
counts once, and there is no fusion, so every op's operands and result are
its bytes.  In the same pass it keeps the program's live bytes and their
peak, as XLA's ``memory_analysis()`` reports them for a compiled one.
"""
from __future__ import annotations

import re
import weakref
from typing import Dict, List, Optional, Set, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .hlo import (
    _CALL_RE,
    _HEADER_RE,
    CollectiveOp,
    _parse_blocks,
    computation_multiplicities,
    shape_bytes,
)

_DEF_RE = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(\([^=]*?\)|\w+\[[\d,]*\](?:\{[^}]*\})?)\s*([\w\-]+)\(")
_OPERANDS_RE = re.compile(r"%([\w.\-]+)")
_LHS_C_RE = re.compile(r"lhs_contracting_dims=\{([\d,]*)\}")
_LHS_B_RE = re.compile(r"lhs_batch_dims=\{([\d,]*)\}")

_ELEMENTWISE_1 = {
    "add", "subtract", "multiply", "divide", "maximum", "minimum", "power",
    "and", "or", "xor", "not", "negate", "abs", "sign", "compare", "select",
    "clamp", "floor", "ceil", "round-nearest-afz", "round-nearest-even",
    "remainder", "atan2", "shift-left", "shift-right-logical",
    "shift-right-arithmetic",
}
_TRANSCENDENTAL = {"exponential", "exponential-minus-one", "log", "log-plus-one",
                   "tanh", "sqrt", "rsqrt", "cbrt", "logistic", "sin", "cos",
                   "tan", "erf", "expm1", "log1p"}
_NO_BYTES = {"parameter", "constant", "get-tuple-element", "tuple", "bitcast",
             "after-all", "iota", "partition-id", "replica-id"}


def _shape_elems(shape_str: str) -> int:
    b = shape_bytes(shape_str)
    m = re.match(r"(\w+)\[", shape_str.strip())
    if not m:
        return 0
    from .hlo import _DTYPE_BYTES
    per = _DTYPE_BYTES.get(m.group(1), 4)
    return b // per if per else 0


def _shape_dims(shape_str: str) -> List[int]:
    m = re.search(r"\[([\d,]*)\]", shape_str)
    if not m or not m.group(1):
        return []
    return [int(x) for x in m.group(1).split(",")]


class BlockCost:
    __slots__ = ("flops", "bytes")

    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0


def _fusion_called_blocks(blocks: Dict[str, List[str]]) -> Set[str]:
    """Blocks invoked by a `fusion(` call site (their bytes are not HBM)."""
    out: Set[str] = set()
    for lines in blocks.values():
        for line in lines:
            if " fusion(" in line or "kind=kLoop" in line or "kind=kInput" in line or "kind=kOutput" in line:
                for m in _CALL_RE.finditer(line):
                    out.add(m.group(1))
    return out


def _byte_transparent_blocks(blocks: Dict[str, List[str]]) -> Set[str]:
    """Computations whose HBM traffic is charged at their call site, matching
    XLA's 'bytes accessed': fusion bodies (``calls=``) and any ``to_apply=``
    callee — plain ``call`` targets (the CPU backend's parallel regions) and
    reduce/reduce-window/sort subcomputations.  While-loop bodies/conditions
    are *not* included (``condition=``/``body=`` attributes): their traffic is
    real per iteration and is what the loop-aware model exists to count."""
    out = _fusion_called_blocks(blocks)
    for lines in blocks.values():
        for line in lines:
            for m in _CALL_RE.finditer(line):
                out.add(m.group(1))
    return out


_PARAM_DEF_RE = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(\([^=]*?\)|\w+\[[\d,]*\](?:\{[^}]*\})?)\s*parameter\(")


def _fusion_read_bytes(lines: List[str]) -> float:
    """HBM bytes read by a fused computation: a parameter consumed *only* by
    dynamic-slice/gather reads only the sliced elements, not the whole buffer
    (this is how scan's per-iteration weight slicing stays O(slice))."""
    shapes: Dict[str, str] = {}
    params: Dict[str, str] = {}
    for line in lines:
        pm = _PARAM_DEF_RE.match(line)
        if pm:
            params[pm.group(1)] = pm.group(2)
        dm = _DEF_RE.match(line)
        if dm:
            shapes[dm.group(1)] = dm.group(2)
    reads = 0.0
    for pname, pshape in params.items():
        if pshape.startswith("("):
            continue  # tuple params are loop plumbing
        full = shape_bytes(pshape)
        sliced = 0.0
        only_sliced = True
        used = False
        ref = re.compile(r"%" + re.escape(pname) + r"\b")
        for line in lines:
            dm = _DEF_RE.match(line)
            if not dm:
                continue
            nm, shape, op = dm.groups()
            if nm == pname:
                continue
            body = line.split(op + "(", 1)
            if len(body) != 2 or not ref.search(body[1]):
                continue
            used = True
            if op in ("dynamic-slice", "gather", "slice"):
                # first operand is the sliced buffer; index operands are scalars
                first = _OPERANDS_RE.search(body[1])
                if first and first.group(1) == pname:
                    sliced += shape_bytes(shape) if not shape.startswith("(") else 0
                else:
                    only_sliced = False
            elif op == "dynamic-update-slice":
                ops = _OPERANDS_RE.findall(body[1])
                if ops and ops[0] == pname:
                    # in-place update: reads nothing beyond the written region
                    upd = shapes.get(ops[1], "") if len(ops) > 1 else ""
                    sliced += shape_bytes(upd) if upd and not upd.startswith("(") else 0
                else:
                    only_sliced = False
            else:
                only_sliced = False
        if not used:
            continue
        reads += min(sliced, full) if only_sliced else full
    return reads


def roofline_seconds(flops: float, bytes_: float, *,
                     peak_flops_s: float, peak_bytes_s: float) -> float:
    """Roofline execution-time bound for one step: the slower of the compute
    and memory terms.  This is the service-time oracle entry the v4 cost
    calculus uses for model functions
    (:class:`repro_torch.analysis.RooflineOracle`)."""
    if peak_flops_s <= 0 or peak_bytes_s <= 0:
        raise ValueError("roofline peaks must be positive")
    return max(flops / peak_flops_s, bytes_ / peak_bytes_s)


def analyze(hlo_text: str) -> Dict[str, float]:
    """Loop-aware {'flops', 'bytes'} per device per step."""
    blocks, _entry = _parse_blocks(hlo_text)
    mult = computation_multiplicities(hlo_text)
    fusion_blocks = _byte_transparent_blocks(blocks)

    total_flops = 0.0
    total_bytes = 0.0
    for name, lines in blocks.items():
        m = mult.get(name, 0.0)
        if m <= 0:
            continue
        # symbol table: op name -> result shape string
        shapes: Dict[str, str] = {}
        parsed: List[Tuple[str, str, str, str]] = []  # (name, shape, op, line)
        for line in lines:
            dm = _DEF_RE.match(line)
            if not dm:
                continue
            nm, shape, op = dm.groups()
            shapes[nm] = shape
            parsed.append((nm, shape, op, line))

        bf = 0.0
        bb = 0.0
        for nm, shape, op, line in parsed:
            elems = _shape_elems(shape) if not shape.startswith("(") else 0
            if op == "dot":
                k = 1
                lc = _LHS_C_RE.search(line)
                ops = _OPERANDS_RE.findall(line.split("dot(", 1)[1])
                lhs_shape = shapes.get(ops[0], "") if ops else ""
                dims = _shape_dims(lhs_shape)
                if lc and dims:
                    for idx in (int(x) for x in lc.group(1).split(",") if x != ""):
                        if idx < len(dims):
                            k *= dims[idx]
                bf += 2.0 * elems * k
            elif op in _ELEMENTWISE_1:
                bf += elems
            elif op in _TRANSCENDENTAL:
                bf += elems
            elif op in ("reduce", "reduce-window"):
                ops = _OPERANDS_RE.findall(line.split(op + "(", 1)[1])
                if ops and ops[0] in shapes:
                    bf += _shape_elems(shapes[ops[0]])
                else:
                    bf += elems
            # ---- bytes (HBM traffic) ----
            if name in fusion_blocks:
                continue
            if op in _NO_BYTES or op == "reshape":
                continue
            rb = shape_bytes(shape) if not shape.startswith("(") else sum(
                shape_bytes(p) for p in shape.strip("()").split(","))
            after = line.split(op + "(", 1)
            arg_str = ""
            if len(after) == 2:
                depth = 1
                buf = []
                for ch in after[1]:
                    if ch == "(":
                        depth += 1
                    elif ch == ")":
                        depth -= 1
                        if depth == 0:
                            break
                    buf.append(ch)
                arg_str = "".join(buf)
            operand_names = [om.group(1) for om in _OPERANDS_RE.finditer(arg_str)]
            if op == "fusion":
                callee = None
                cm = _CALL_RE.search(line)
                if cm:
                    callee = cm.group(1)
                ob = _fusion_read_bytes(blocks.get(callee, [])) if callee else 0.0
            elif op in ("dynamic-slice", "slice", "gather"):
                ob = rb  # reads only the sliced elements
            elif op == "dynamic-update-slice":
                upd = shapes.get(operand_names[1], "") if len(operand_names) > 1 else ""
                ub = shape_bytes(upd) if upd and not upd.startswith("(") else rb
                ob, rb = ub, ub  # in-place: read+write the updated region only
            else:
                ob = 0
                for onm in operand_names:
                    s = shapes.get(onm)
                    if s and not s.startswith("("):
                        ob += shape_bytes(s)
            bb += rb + ob
        total_flops += m * bf
        total_bytes += m * bb
    return {"flops": total_flops, "bytes": total_bytes}


# --------------------------------------------------------------------------- #
# the same rules on PyTorch's aten op stream
# --------------------------------------------------------------------------- #

#: matrix products: 2 * prod(result) * K, K the contracted extent of the lhs
#: (its last dim; ``addmm`` / ``baddbmm`` take the lhs second)
_PRODUCTS = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1}
#: reductions: prod(operand), as XLA's ``reduce``
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "argmax",
               "argmin", "any", "all", "logsumexp", "cumsum", "cumprod",
               "var", "var_mean", "std", "norm", "linalg_vector_norm",
               "_softmax", "_log_softmax"}
#: data movement that aten tags pointwise: no flops, as XLA's ``copy`` and
#: ``convert``
_COPIES = {"clone", "copy_", "copy", "_to_copy", "contiguous"}
#: ops that move no data besides views (``func.is_view``), factory ops (no
#: tensor operand) and metadata queries (no tensor result)
_NO_BYTES_ATEN = {"_unsafe_view", "lift_fresh", "wait_tensor"}
#: functional collectives (native and legacy namespaces) -> the HLO kind
_COLLECTIVES = {"all_reduce": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all",
                "broadcast": "collective-broadcast"}
#: the DTensor sharding propagator runs each op once on fake global-shape
#: tensors to learn its output's metadata; that run is not the program's
_PROPAGATION_FRAME = "_propagate_tensor_meta_non_cached"


def _tensors(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    for a in tree:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(_tensors(a))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _held_tensors(tree) -> List[torch.Tensor]:
    """The tensors in ``tree`` (dicts, lists, tuples, modules' parameters
    and buffers), a DTensor as its local shard."""
    if isinstance(tree, torch.nn.Module):
        return _held_tensors(list(tree.parameters())
                            + list(tree.buffers()))
    if isinstance(tree, dict):
        return _held_tensors(list(tree.values()))
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _held_tensors(v)]
    if isinstance(tree, torch.Tensor):
        return [getattr(tree, "_local_tensor", tree)]
    return []


def _storage_bytes(tensors) -> int:
    """The bytes of the distinct storages under ``tensors``."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _in_propagation() -> bool:
    import sys

    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name == _PROPAGATION_FRAME:
            return True
        f = f.f_back
    return False


class OpCounter(TorchDispatchMode):
    """Counts what a PyTorch program executes, op by op, with
    :func:`analyze`'s rules: matrix products ``2 * prod(result) * K``,
    elementwise and transcendental ops (aten's ``pointwise`` tag)
    ``prod(result)``, reductions ``prod(operand)``; bytes are each executed
    op's operand bytes plus its result bytes, except for views, metadata
    queries and factory ops (no tensor operand), as :func:`analyze` skips
    ``parameter``, ``constant``, ``bitcast`` and friends.  The product
    flops are also kept on their own (``product_flops``).

    It runs under ``FakeTensorMode`` as well as on real tensors.  Inside a
    DTensor program it lets DTensor run first and counts the local shards'
    ops, so the counts are per device, as partitioned HLO's are; the
    functional collectives DTensor issues are kept in ``collectives`` as
    ``(kind, result bytes, group name)``, their link bytes left to the
    caller, which knows each group's size and link.

    Live bytes are kept by storage: the storages of ``hold`` (the
    program's arguments: the tensors in its dicts, lists, tuples and
    modules, a DTensor's local shard) are live at entry; each op's result
    adds its storage's bytes the first time that storage is seen (a view,
    an in-place op or an ``out=`` result reuses a storage and adds
    nothing, a collective's result counts as any other); a storage's bytes
    go when it is freed (a held one too: a step may drop an argument from
    a container it was given).  ``peak_bytes`` is the highest total;
    ``written`` holds the bytes of each held storage an op wrote in place.
    The tensors DTensor's sharding propagator makes are global-shape
    fakes, not the program's, and count for nothing; nor does the scratch
    a kernel allocates and frees within one op."""

    def __init__(self, hold=()):
        super().__init__()
        self.flops = 0.0
        self.product_flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.collectives: List[Tuple[str, int, str]] = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}  # storage key -> its bytes
        self._finalizers: Dict[int, weakref.finalize] = {}
        for t in _held_tensors(hold):
            self._add(t)
        self.argument_bytes = self.live_bytes
        self.held = dict(self._live)  # the held storages still live
        self.written: Dict[int, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor desugars into local ops first
        out = func(*args, **kwargs)
        if not _in_propagation():
            self._count(func, args, kwargs, out)
            self._track(func, args, kwargs, out)
        return out

    def __exit__(self, *exc):
        for f in list(self._finalizers.values()):  # later frees: not ours
            f.detach()
        self._finalizers.clear()
        return super().__exit__(*exc)

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key, n = st._cdata, st.nbytes()
        had = self._live.get(key)
        if had is None:
            self._finalizers[key] = weakref.finalize(st, self._free, key)
        elif n <= had:
            return
        self._live[key] = n
        self.live_bytes += n - (had or 0)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, key: int) -> None:
        self._finalizers.pop(key, None)
        self.held.pop(key, None)  # its key may name a new storage now
        self.live_bytes -= self._live.pop(key, 0)

    def _track(self, func, args, kwargs, out) -> None:
        if func._schema.is_mutable:
            for i, a in enumerate(func._schema.arguments):
                if a.alias_info is None or not a.alias_info.is_write:
                    continue
                t = kwargs.get(a.name) if a.kwarg_only or i >= len(args) \
                    else args[i]
                for x in _tensors((t,)):
                    key = x.untyped_storage()._cdata
                    if key in self.held:
                        self.written[key] = self.held[key]
        for t in _tensors(out if isinstance(out, (list, tuple)) else (out,)):
            self._add(t)

    def _count(self, func, args, kwargs, out) -> None:
        name = func._overloadpacket.__name__
        ns = func.namespace
        ins = _tensors(args) + _tensors(kwargs.values())
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        if ns in ("_c10d_functional", "c10d_functional") \
                and name in _COLLECTIVES:
            group = args[-1] if isinstance(args[-1], str) \
                else kwargs.get("group_name")
            self.collectives.append((_COLLECTIVES[name],
                                     sum(_nbytes(t) for t in outs), group))
        if not ins or not outs or func.is_view or name in _NO_BYTES_ATEN:
            return  # a factory op, a metadata query or a view
        self.ops += 1
        res = sum(t.numel() for t in outs)
        if name in _PRODUCTS:
            lhs = ins[_PRODUCTS[name]]
            f = 2.0 * res * lhs.shape[-1]
            self.product_flops += f
            self.flops += f
        elif torch.Tag.pointwise in func.tags and name not in _COPIES:
            self.flops += res
        elif name in _REDUCTIONS:
            self.flops += ins[0].numel()
        if name == "copy_":  # reads the source, writes the destination
            ins = ins[1:]
        self.bytes += sum(_nbytes(t) for t in ins) \
            + sum(_nbytes(t) for t in outs)

    def memory(self, out, argument_bytes: Optional[int] = None
               ) -> Dict[str, int]:
        """The ``memory`` record of :mod:`repro_torch.launch.dryrun`, whose
        docstring defines its keys, for a program that returned ``out``;
        ``argument_bytes`` defaults to the held storages' bytes."""
        if argument_bytes is None:
            argument_bytes = self.argument_bytes
        out_bytes = _storage_bytes(
            t for t in _held_tensors(out)
            if t.untyped_storage()._cdata not in self.held)
        return {"argument_bytes": argument_bytes,
                "output_bytes": out_bytes,
                "temp_bytes": max(0, self.peak_bytes - argument_bytes
                                  - out_bytes),
                "peak_bytes": self.peak_bytes,
                "alias_bytes": sum(self.written.values())}

    def counts(self) -> Dict[str, float]:
        """``{"flops", "bytes", "product_flops", "peak_bytes"}`` so far."""
        return {"flops": self.flops, "bytes": self.bytes,
                "product_flops": self.product_flops,
                "peak_bytes": self.peak_bytes}


def count(fn, *args, **kwargs) -> Tuple[object, Dict[str, float]]:
    """``fn(*args, **kwargs)`` under a fresh :class:`OpCounter` holding the
    arguments: its result and :meth:`OpCounter.counts`."""
    with OpCounter(hold=(args, kwargs)) as c:
        out = fn(*args, **kwargs)
    return out, c.counts()


def collective_link_bytes(kind: str, result_bytes: int,
                          group_size: int) -> float:
    """One collective's link bytes per device, by :mod:`.hlo`'s ring
    formulas."""
    return CollectiveOp(kind=kind, result_bytes=result_bytes,
                        group_size=group_size, line="").link_bytes
