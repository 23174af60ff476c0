"""train_step / prefill_step / serve_step factories.

Each returns a plain function over ``(model, ...)``.  The prefill and serve
steps run under ``torch.no_grad()``.  The train step runs the loss through
``model_loss`` under autograd: no hand-written kernel has a backward (nor
has any Pallas kernel of the JAX package), so attention goes through
``cfg.attn_impl`` ("chunked" by default, as in the reference), the mamba
layers through the differentiable scan (``scan_impl="chunked"``), and the
kernel entries refuse inputs that require grad.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import (model_decode_step, model_forward,
                                      model_loss)
from repro_torch.models.transformer import lm_logits
from repro_torch.optim import adamw
from repro_torch.optim.compress import GradCompressor

def batch_to(batch: Mapping, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (``data.pipeline.make_batch``) as tensors on
    ``device``: token ids and labels as int64, frames and patches as they
    are (float32)."""
    out = {}
    for name, arr in batch.items():
        t = torch.as_tensor(np.asarray(arr))
        if not t.is_floating_point():
            t = t.long()
        out[name] = t.to(device)
    return out


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: adamw.AdamWConfig,
    *,
    impl: str = None,
    scan_impl: str = "chunked",
    microbatches: int = 1,
    compressor: Optional[GradCompressor] = None,
) -> Callable:
    """(model, opt_state, batch) -> (model, opt_state, metrics).

    The gradients are ``torch.autograd`` gradients of ``model_loss`` with
    respect to every parameter (turned on for the step, off again after).
    ``microbatches > 1`` accumulates them in float32 over equal splits of
    the batch and divides, as the reference does.  Then the optional
    compressor and ``adamw.update``, which writes the parameters and the
    moments in place.  ``metrics``: ``loss``, ``grad_norm`` and ``lr`` as
    0-d float32 tensors.

    The ssm and hybrid families' mamba layers take the differentiable scan
    (``scan_impl="chunked"``: ``cfg.scan_chunk``, ``cfg.ssm_scan_dtype``),
    as ``impl`` takes attention off the kernel; ``scan_impl="kernel"``
    reaches the scan kernel, whose entry refuses inputs that require
    grad."""

    def grads_of(model, params, batch):
        loss = model_loss(cfg, model, batch, impl=impl, scan_impl=scan_impl)
        return loss, torch.autograd.grad(loss, list(params.values()))

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
        try:
            if microbatches > 1:
                B = next(iter(batch.values())).shape[0]
                if B % microbatches:
                    raise ValueError(f"batch {B} does not split into "
                                     f"{microbatches} microbatches")
                n = B // microbatches
                losses = []
                acc = [torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device) for p in params.values()]
                for i in range(microbatches):
                    mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                    mloss, grads = grads_of(model, params, mb)
                    losses.append(mloss.detach())
                    for a, g in zip(acc, grads):
                        a.add_(g)
                loss = sum(losses) / microbatches
                grads = [a / microbatches for a in acc]
            else:
                loss, grads = grads_of(model, params, batch)
                loss = loss.detach()
        finally:
            for p in params.values():
                p.requires_grad_(False)
        grads = dict(zip(params, grads))

        if compressor is not None:
            grads, opt_state = compressor.apply(grads, opt_state)
            core = {k: v for k, v in opt_state.items() if k != "compress"}
            _, core, metrics = adamw.update(opt_cfg, params, grads, core)
            opt_state = {**core, "compress": opt_state["compress"]}
        else:
            _, opt_state, metrics = adamw.update(opt_cfg, params, grads,
                                                 opt_state)
        metrics["loss"] = loss
        return model, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, *, impl: str = None,
                      scan_impl: str = "kernel") -> Callable:
    """(model, batch) -> last-position logits [B, vocab] (f32).  The mamba
    layers run the scan kernel unless ``scan_impl`` asks for the
    differentiable scan (as the reference's prefill runs its jnp scan)."""

    @torch.no_grad()
    def prefill_step(model, batch):
        hidden = model_forward(cfg, model, batch, impl=impl,
                               scan_impl=scan_impl)
        return lm_logits(cfg, model, hidden[:, -1:])[:, 0]

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """(model, cache, token) -> (logits [B, vocab], new cache)."""

    @torch.no_grad()
    def serve_step(model, cache, token):
        return model_decode_step(cfg, model, cache, token)

    return serve_step
