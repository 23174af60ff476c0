"""Carry state into the port as plain data: a cluster's scheduling state,
and a model's parameters.

The port shares no objects with the JAX package, so a running cluster
crosses over as plain data — a snapshot any caller can take from its own
tables — and is replayed into the port's :class:`ClusterState` and
:class:`Registry`.  Replaying in order reproduces the worker order (the
order ``conf()`` lists workers, which decides ``best_first`` ties) and the
activation ids of the running instances; the snapshot's ``next_id`` makes
new ids continue where the source's do.  A model's parameters cross as the
reference's parameter pytree with numpy leaves (:func:`lm_params_from_jax`).
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from .configs.base import ModelConfig
from .core.state import ClusterState, Registry

#: (name, max_memory, zone, alive); zone "" or None for an unzoned worker
WorkerRow = Tuple[str, float, Optional[str], bool]
#: (activation_id, function, worker), activation ids of the form "act-<n>"
ActivationRow = Tuple[str, str, str]


def _id_number(activation_id: str) -> int:
    prefix, _, n = activation_id.partition("-")
    if prefix != "act" or not n.isdigit():
        raise ValueError(f"activation id {activation_id!r} is not 'act-<n>'")
    return int(n)


def state_from_snapshot(
        workers: Iterable[WorkerRow],
        activations: Iterable[ActivationRow],
        registry: Mapping[str, Tuple[float, str]],
        next_id: Optional[int] = None,
) -> Tuple[ClusterState, Registry]:
    """Replay a snapshot into a fresh port ``(ClusterState, Registry)``.

    ``workers`` lists every worker in the source's order (dead ones too,
    ``alive=False``, so a later re-join lands in the same slot);
    ``activations`` lists the running instances in id order; ``registry``
    maps each function to ``(memory, tag)``.  Ids the source has already
    retired (completed activations) are skipped, so the replayed ids equal
    the source's.  ``next_id`` is the number of the id the source would
    issue next (``n`` of ``act-<n>``): the port's next allocation gets it,
    also when the source's newest activations have completed.  Without it,
    new ids continue after the last replayed one."""
    reg = Registry()
    for name, (memory, tag) in registry.items():
        reg.register(name, memory=float(memory), tag=tag)
    state = ClusterState()
    for name, max_memory, zone, alive in workers:
        state.add_worker(name, max_memory=float(max_memory),
                         zone=zone or None)
        if not alive:
            state.fail_worker(name)
    next_n = 0
    for activation_id, function, worker in activations:
        n = _id_number(activation_id)
        if n < next_n:
            raise ValueError(f"activations out of id order at "
                             f"{activation_id!r}")
        if n > next_n:
            _resume_ids(state, n)  # skip ids retired at the source
        act = state.allocate(function, worker, reg)
        if act.activation_id != activation_id:  # the id scheme drifted
            raise ValueError(f"replayed {act.activation_id!r} for "
                             f"{activation_id!r}")
        next_n = n + 1
    if next_id is not None:
        if next_id < next_n:
            raise ValueError(f"next_id {next_id} is not above the last "
                             f"replayed activation (act-{next_n - 1})")
        _resume_ids(state, next_id)
    return state, reg


def _resume_ids(state: ClusterState, n: int) -> None:
    """Make ``act-<n>`` the next id ``state`` issues.  ``ClusterState``
    (a verbatim copy of the reference's) has no public setter for its id
    counter, so the replay sets it here, in this one place."""
    state._ids = itertools.count(n)


def _tensor(arr) -> torch.Tensor:
    """A numpy leaf as a tensor; bfloat16 leaves (numpy's ``bfloat16``
    extension type) cross through their bits."""
    arr = np.array(arr)  # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _flatten(prefix: str, tree, out: Dict[str, Any], index=None) -> None:
    """Nested dicts of leaves into ``prefix.name`` keys; ``index`` picks one
    slice of a ``[G, ...]`` scan stack."""
    for name, leaf in tree.items():
        key = f"{prefix}.{name}"
        if isinstance(leaf, Mapping):
            _flatten(key, leaf, out, index)
        else:
            out[key] = np.asarray(leaf)[index] if index is not None \
                else np.asarray(leaf)


def lm_params_from_jax(cfg: ModelConfig, tree, *, device="cuda"):
    """The reference's decoder-only LM parameters (the pytree of
    ``repro.models.init_model``, leaves as numpy arrays) as the port's
    :class:`repro_torch.models.transformer.LM` on ``device``.

    The reference keeps one ``[G, ...]`` stack per period position in
    ``tree["layers"]`` and the unrolled remainder in ``tree["tail"]``; the
    port's flat layer list takes group g, position p as layer
    ``g * period + p`` and the tail after them.  ``lm_head`` is present
    only without ``tie_embeddings``.  Names, shapes and the set of leaves
    must match the port's parameters exactly, or it raises."""
    from .kernels.affinity.ops import resolve_device
    from .models.layers import dtype_of
    from .models.transformer import LM, check_supported

    check_supported(cfg)
    dev = resolve_device(device)
    flat: Dict[str, Any] = {}
    for name in ("embed", "final_norm", "frontend"):
        if name in tree:
            _flatten(name, tree[name], flat)
    if "lm_head" in tree:
        flat["lm_head"] = np.asarray(tree["lm_head"])
    n_stacked = cfg.n_groups * cfg.period
    for i in range(n_stacked):
        g, p = divmod(i, cfg.period)
        _flatten(f"layers.{i}", tree["layers"][p], flat, index=g)
    for t in range(cfg.n_tail):
        _flatten(f"layers.{n_stacked + t}", tree["tail"][t], flat)
    model = LM(cfg, generator=None, device="meta")
    want = {k: tuple(p.shape) for k, p in model.named_parameters()}
    got = {k: tuple(v.shape) for k, v in flat.items()}
    if want != got:
        raise ValueError(
            f"the pytree does not match {cfg.name}'s parameters: missing "
            f"{sorted(want.keys() - got.keys())}, unexpected "
            f"{sorted(got.keys() - want.keys())}, shapes differ at "
            f"{sorted(k for k in want.keys() & got.keys() if want[k] != got[k])}")
    dt = dtype_of(cfg.dtype)
    for key, arr in flat.items():
        owner, _, name = key.rpartition(".")
        setattr(model.get_submodule(owner), name, torch.nn.Parameter(
            _tensor(arr).to(device=dev, dtype=dt), requires_grad=False))
    return model
