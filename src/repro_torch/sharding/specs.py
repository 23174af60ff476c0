"""Partition-spec rules: DP/FSDP over the data axes, TP/EP over ``model``,
SP over ``data`` for single-sequence long-context caches, as the
reference's ``sharding/specs.py``.

A spec is a tuple with one entry per tensor dim: ``None`` (replicated), a
mesh axis name, or a tuple of axis names (the dim split over their
product, major first) — the entries of a ``jax.sharding.PartitionSpec``.
Specs are derived from the *name* of each parameter or cache leaf (rules
keyed on the port's names, ``.`` read as ``/``, applied to trailing dims),
with divisibility guards so e.g. seamless' vocab of 256206 silently falls
back to replication.  The reference's stacked leaves carry a leading
scan-group axis, always unsharded; the port's layers are a
``ModuleList``, so its spec for a layer's leaf is the reference's without
that leading ``None``.

The rules need only the mesh's axis sizes: every function takes a
``DeviceMesh`` or a ``{axis name: size}`` mapping.  :func:`to_placements`
turns a spec into DTensor placements on a ``DeviceMesh``.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

from repro_torch.configs.base import ModelConfig

Axes = Optional[Union[str, Tuple[str, ...]]]
Spec = Tuple[Axes, ...]


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (or of a mapping)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh_axes(mesh) else ("data",)


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_axes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


class SpecBuilder:
    def __init__(self, mesh, *, fsdp: bool, tp2d: bool = False):
        self.mesh = mesh_axes(mesh)
        self.data = data_axes(self.mesh)
        self.fsdp_ax = self.data if fsdp else None
        # tp2d (decode placement): weights tensor-parallel over BOTH the data
        # and model axes — nothing is gathered per token
        self.model_ax = ("data", "model") if tp2d else "model"

    def _fit(self, dim: int, axes) -> Axes:
        """Return axes if dim divides the axes product, else None
        (replicate)."""
        if axes is None:
            return None
        if dim % axis_size(self.mesh, axes) != 0:
            return None
        return axes

    def trailing(self, shape: Sequence[int],
                 rule: Sequence[Optional[str]]) -> Spec:
        """Apply a trailing-dims rule, padding leading dims with None."""
        n_lead = len(shape) - len(rule)
        assert n_lead >= 0, (shape, rule)
        spec = [None] * n_lead
        for dim, r in zip(shape[n_lead:], rule):
            ax = {"model": self.model_ax, "fsdp": self.fsdp_ax, None: None}[r]
            spec.append(self._fit(dim, ax))
        return tuple(spec)


# param-leaf rules: name -> trailing-dims rule (None entries replicate)
_PARAM_RULES = [
    (r"embed/tok$", ("model", "fsdp")),
    (r"lm_head$", ("fsdp", "model")),
    (r"frontend/w1$", (None, "model")),
    (r"frontend/w2$", ("model", None)),
    (r"frontend_proj$", (None, None)),
    (r"(attn|cross)/w[qkv]$", ("fsdp", "model")),
    (r"(attn|cross)/b[qkv]$", ("model",)),
    (r"(attn|cross)/wo$", ("model", "fsdp")),
    (r"moe/router$", (None, None)),
    (r"moe/w_(gate|up)$", ("model", "fsdp", None)),
    (r"moe/w_down$", ("model", None, "fsdp")),
    (r"mlp/w_(gate|up)$", ("fsdp", "model")),
    (r"mlp/b_up$", ("model",)),
    (r"mlp/w_down$", ("model", "fsdp")),
    (r"mlp/b_down$", (None,)),
    (r"ssm/in_proj$", ("fsdp", "model")),
    (r"ssm/conv_w$", ("model", None)),
    (r"ssm/conv_b$", ("model",)),
    (r"ssm/x_proj$", ("model", None)),
    (r"ssm/dt_w$", (None, "model")),
    (r"ssm/dt_b$", ("model",)),
    (r"ssm/a_log$", ("model", None)),
    (r"ssm/d_skip$", ("model",)),
    (r"ssm/out_proj$", ("model", "fsdp")),
    (r"ln\d?/[wb]$|_norm/[wb]$", (None,)),
]


def _path(name: str) -> str:
    return name.replace(".", "/")


def param_specs(params: Mapping[str, Any], mesh, *, fsdp: bool,
                tp2d: bool = False) -> Dict[str, Spec]:
    """``{name: spec}`` for ``{name: tensor}`` (``named_parameters()``,
    meta or fake tensors do)."""
    b = SpecBuilder(mesh, fsdp=False if tp2d else fsdp, tp2d=tp2d)

    def leaf_spec(name, leaf) -> Spec:
        ps = _path(name)
        for pat, rule in _PARAM_RULES:
            if re.search(pat, ps):
                return b.trailing(leaf.shape, rule)
        return (None,) * len(leaf.shape)  # replicate unmatched

    return {k: leaf_spec(k, v) for k, v in params.items()}


def opt_state_specs(param_spec_tree: Mapping[str, Spec],
                    extras: Mapping[str, Any], mesh) -> Dict[str, Any]:
    """Optimizer state mirrors param sharding; scalars replicate."""
    out = {"m": param_spec_tree, "v": param_spec_tree, "step": ()}
    if "master" in extras:
        out["master"] = param_spec_tree
    return out


def _leaves(tree, prefix: str = ""):
    """``(path, tensor)`` of every tensor in nested dicts and lists."""
    items = tree.items() if isinstance(tree, Mapping) else enumerate(tree)
    for k, v in items:
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (Mapping, list, tuple)):
            yield from _leaves(v, path)
        elif hasattr(v, "shape"):
            yield path, v


def cache_specs(cache_tree, mesh, *, batch: int,
                tp2d: bool = False) -> Dict[str, Spec]:
    """Decode-cache sharding, ``{path: spec}`` for every tensor of the
    cache (paths ``layers/<i>/<leaf>``; the integer ``pos`` and
    ``cache_len`` are host values).  Batch over data when it divides;
    otherwise SP: the sequence axis of attention caches shards over
    ``data``.  Head_dim (all multiples of the model-axis size) carries TP
    for k/v; d_inner for SSM.  With ``tp2d`` the sequence axis shards over
    data and head_dim over model, matching the 2D-TP weight layout (batch
    stays local)."""
    b = SpecBuilder(mesh, fsdp=False)
    dax = b.data
    batch_ok = (not tp2d) and batch % axis_size(b.mesh, dax) == 0

    def leaf_spec(ps, leaf) -> Spec:
        shape = leaf.shape
        nd = len(shape)
        if ps.endswith("pos") or ps.endswith("cache_len"):
            return ()
        if re.search(r"(^|/)(bk|bv)$", ps):
            # append buffer [B, BUF, K, hd]: tiny, never seq-sharded
            rule = [None] * nd
            if batch_ok:
                rule[nd - 4] = b._fit(shape[nd - 4], dax)
            rule[nd - 1] = b._fit(shape[nd - 1], "model")
            return tuple(rule)
        if re.search(r"(^|/)(k|v|cross_k|cross_v)$", ps):
            # [B, L, K, hd]
            rule = [None] * nd
            bdim = nd - 4
            if batch_ok:
                rule[bdim] = b._fit(shape[bdim], dax)
            else:
                rule[bdim + 1] = b._fit(shape[bdim + 1], "data")
            rule[nd - 1] = b._fit(shape[nd - 1], "model")
            return tuple(rule)
        if re.search(r"(^|/)(conv|h)$", ps):
            # [B, di, *]
            rule = [None] * nd
            bdim = nd - 3
            if batch_ok:
                rule[bdim] = b._fit(shape[bdim], dax)
            rule[bdim + 1] = b._fit(shape[bdim + 1], "model")
            return tuple(rule)
        return (None,) * nd

    return {ps: leaf_spec(ps, leaf) for ps, leaf in _leaves(cache_tree)}


def activation_rules(cfg: ModelConfig, mesh, *,
                     batch: int) -> Dict[str, Spec]:
    """Logical-name rules consumed by
    :func:`repro_torch.sharding.ctx.shard`."""
    b = SpecBuilder(mesh, fsdp=False)
    dax = b.data
    moe_g = None
    if cfg.moe is not None:
        moe_g = dax  # dispatch groups ride the data axes
    vocab_tp = "model" if cfg.vocab % axis_size(b.mesh, "model") == 0 \
        else None
    rules = {
        "act_btd": (dax, None, None),
        "act_bti": (dax, None, "model"),
        "logits": (dax, vocab_tp),
        "logits_bv": (dax if batch % axis_size(b.mesh, dax) == 0 else None,
                      vocab_tp),
    }
    if cfg.attn_tp == "head":
        # q sharded over heads; k/v replicated across model — the score
        # contraction stays local
        rules["attn_q"] = (dax, None, "model", None)
        rules["attn_out"] = (dax, None, "model", None)
        rules["attn_kv"] = (dax, None, None, None)
    if moe_g is not None:
        rules["moe_tokens"] = (moe_g, None, None)
        rules["moe_dispatch"] = (moe_g, None, "model", None)
        rules["moe_expert_in"] = (moe_g, "model", None, None)
    if batch % axis_size(b.mesh, dax) != 0:  # single-sequence decode: no DP
        rules["act_btd"] = (None, None, None)
        rules["act_bti"] = (None, None, "model")
        if moe_g is not None:
            rules["moe_tokens"] = (None, None, None)
            rules["moe_dispatch"] = (None, None, "model", None)
            rules["moe_expert_in"] = (None, "model", None, None)
    return rules


def batch_specs(batch_tree: Mapping[str, Any], mesh, *,
                batch: int) -> Dict[str, Spec]:
    """Token/frame/label inputs: batch dim over the data axes."""
    b = SpecBuilder(mesh, fsdp=False)
    dax = b.data if batch % axis_size(b.mesh, b.data) == 0 else None

    def leaf_spec(leaf) -> Spec:
        rule = [None] * len(leaf.shape)
        if len(leaf.shape) >= 1 and dax is not None:
            rule[0] = dax
        return tuple(rule)

    return {k: leaf_spec(v) for k, v in batch_tree.items()}


def to_placements(spec: Spec, mesh) -> list:
    """DTensor placements on ``mesh`` (a ``DeviceMesh``) for ``spec``: per
    mesh dim, ``Shard(i)`` for the tensor dim ``i`` whose entry names it,
    else ``Replicate()``.  A dim over several axes (``("pod", "data")``)
    shards on each of their mesh dims, which must come in the spec's order
    (DTensor splits a dim over mesh dims left to right)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for i, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: axes {axes} of dim {i} are not "
                             f"in the mesh's order {names}")
        for d in dims:
            out[d] = Shard(i)
    return out
