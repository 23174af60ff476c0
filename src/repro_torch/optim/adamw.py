"""AdamW over a model's parameters, with global-norm clipping, a cosine
schedule, and configurable moment / master dtypes, as the reference's
``optim/adamw.py``: every step's arithmetic in float32.

The state is ``{"m": {name: tensor}, "v": {name: tensor}, "step": 0-d
int32 tensor}`` (plus ``"master"`` with ``master_weights``), the names
those of ``model.named_parameters()``.  :func:`update` writes the
parameters, the moments and the master copy in place, one parameter at a
time (JAX returns new arrays), so a step needs no second copy of the state:
at full width the moments alone are four times the bf16 weights.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    moment_dtype: str = "float32"  # float32 | bfloat16
    master_weights: bool = False  # keep an fp32 copy of bf16 params


def _mdt(cfg: AdamWConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a 0-d tensor): linear
    warm-up, then a cosine down to ``min_lr_ratio``, in float32."""
    step = _f32(step)
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(_f32(math.pi, step.device) * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _placed_as(g, ref):
    """``g`` in ``ref``'s placements.  A DTensor gradient comes out of
    autograd in DTensor's own layout (partial sums over the axes that split
    the activations, its dims split as the product's strategy chose),
    which the in-place writes of the moments cannot take, a zero-width leaf
    included.  The explicit choice: each gradient is reduced once onto its
    moment's layout (a reduce-scatter where the moment is split, moving
    the gradient's bytes and nothing of a zero-width leaf) before the norm
    and the step.  A plain tensor passes through."""
    from repro_torch.sharding.ctx import is_dtensor

    if is_dtensor(g) and tuple(g.placements) != tuple(ref.placements):
        return g.redistribute(ref.device_mesh, ref.placements)
    return g


def init(cfg: AdamWConfig,
         params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Zero moments in the moment dtype, step 0 (on the parameters'
    device), and with ``master_weights`` a float32 copy of the
    parameters."""
    dt = _mdt(cfg)
    dev = next(iter(params.values())).device

    def zeros(p):  # on a DTensor its local shard's, not the global shape
        return torch.zeros_like(p, dtype=dt,
                                memory_format=torch.contiguous_format)

    state: Dict[str, Any] = {
        "m": {k: zeros(p) for k, p in params.items()},
        "v": {k: zeros(p) for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.master_weights:
        state["master"] = {k: p.detach().float().clone()
                           for k, p in params.items()}
    return state


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.values()))


@torch.no_grad()
def update(cfg: AdamWConfig, params: Mapping[str, torch.Tensor],
           grads: Mapping[str, torch.Tensor], state: Dict[str, Any],
           ) -> Tuple[Mapping[str, torch.Tensor], Dict[str, Any],
                      Dict[str, torch.Tensor]]:
    """One AdamW step: the gradients clipped to ``clip_norm`` by their
    global norm, the moments advanced, and each parameter moved by the
    bias-corrected step plus weight decay, at ``schedule``'s rate.  The
    parameters (and the master copy) and the moments are written in place;
    returns them, the state with ``step`` one further, and ``grad_norm``
    and ``lr``."""
    step = state["step"]
    grads = {k: _placed_as(g, state["m"][k]) for k, g in grads.items()}
    gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    lr = schedule(cfg, step).to(gnorm.device)
    t = (step + 1).float()
    bc1 = 1 - torch.pow(_f32(cfg.b1, t.device), t)
    bc2 = 1 - torch.pow(_f32(cfg.b2, t.device), t)
    base = state["master"] if cfg.master_weights else params
    for name, p in params.items():
        g = grads[name].float()
        if scale is not None:
            g = g * scale
        m, v = state["m"][name], state["v"][name]
        new_m = cfg.b1 * m.float() + (1 - cfg.b1) * g
        new_v = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        m.copy_(new_m)
        v.copy_(new_v)
        mh = m.float() / bc1
        vh = v.float() / bc2
        b = base[name]
        upd = mh / (torch.sqrt(vh) + cfg.eps) \
            + cfg.weight_decay * b.float()
        new = b.float() - lr * upd
        if cfg.master_weights:
            b.copy_(new)
        p.copy_(new)
    state = {**state, "step": step + 1}
    return params, state, {"grad_norm": gnorm, "lr": lr}
