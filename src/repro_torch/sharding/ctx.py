"""Logical sharding-constraint context.

Model code is mesh-agnostic: it calls ``shard(x, "act_btd")`` at layer
boundaries, and the launcher installs a rule table (logical name -> spec,
:func:`repro_torch.sharding.specs.activation_rules`) before running.  On a
DTensor the call redistributes it to the rule's placements on its own
mesh.  Outside any rule context, on a plain tensor, or on a rank mismatch,
the calls are no-ops, so single-device runs take the same code path.

:func:`unflatten` and :func:`sum_partials` are the explicit choices at
the call sites where DTensor has no sharding rule for the op that follows
(``PERF.md`` lists them); they too leave a plain tensor as it is.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Optional, Tuple

from .specs import Spec, axis_size, mesh_axes, to_placements

_TLS = threading.local()


def current_rules() -> Optional[Dict[str, Spec]]:
    return getattr(_TLS, "rules", None)


@contextlib.contextmanager
def sharding_rules(rules: Optional[Dict[str, Spec]]):
    prev = current_rules()
    _TLS.rules = rules
    try:
        yield
    finally:
        _TLS.rules = prev


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def shard(x, name: str):
    rules = current_rules()
    if not rules:
        return x
    spec = rules.get(name)
    if spec is None or not is_dtensor(x):
        return x
    if x.ndim != len(spec):
        return x  # rank mismatch (e.g. reduced smoke shapes): skip
    # a dim its axes do not divide stays whole: GSPMD pads such a dim,
    # DTensor's uneven shards fail in the einsums that follow
    sizes = mesh_axes(x.device_mesh)
    spec = tuple(a if a is None or x.shape[i] % axis_size(sizes, a) == 0
                 else None for i, a in enumerate(spec))
    placements = to_placements(spec, x.device_mesh)
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def shards(x, dim: int) -> int:
    """Into how many shards a DTensor splits ``dim`` (1 for a plain
    tensor)."""
    if not is_dtensor(x):
        return 1
    from torch.distributed.tensor import Shard

    mesh = x.device_mesh
    return math.prod(mesh.size(i) for i, p in enumerate(x.placements)
                     if isinstance(p, Shard) and p.dim == dim % x.ndim)


def data_model_sizes(mesh) -> Tuple[int, int]:
    """(ranks over the data axes, ranks over the model axis) of a
    ``DeviceMesh``."""
    sizes = mesh_axes(mesh)
    model = sizes.pop("model", 1)
    return math.prod(sizes.values()), model


def by_axis(mesh, data, model) -> tuple:
    """A placement per mesh dim: ``model`` on the model axis, ``data`` on
    every other (the data axes)."""
    return tuple(model if d == "model" else data
                 for d in mesh.mesh_dim_names)


def unflatten(x, dim: int, sizes):
    """``x`` with ``dim`` split into ``sizes``, as ``Tensor.unflatten``.
    DTensor cannot split a dim whose shards cut across the new outer dim
    (4 kv heads over a model axis of 8; 2 MoE groups of a batch over 4
    data shards): such a dim is gathered first, the explicit choice where
    GSPMD would pad."""
    if is_dtensor(x) and sizes[0] % shards(x, dim):
        from torch.distributed.tensor import Replicate, Shard

        d = dim % x.ndim
        x = x.redistribute(x.device_mesh, [
            Replicate() if isinstance(p, Shard) and p.dim == d else p
            for p in x.placements])
    return x.unflatten(dim, sizes)


def sum_partials(x):
    """``x`` with its pending partial sums reduced (an all-reduce over the
    axes that hold them), its shards kept; a plain tensor passes through.
    The explicit choice where a partial sum would meet a sharded operand
    that DTensor cannot turn into a partial one."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])
