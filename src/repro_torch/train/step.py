"""prefill_step / serve_step factories.

Both return plain functions over ``(model, ...)`` that run under
``torch.no_grad()``.  ``make_train_step`` (loss, gradients, AdamW) waits
for the training slice (``ROADMAP.md``, Queue 1).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import model_decode_step, model_forward
from repro_torch.models.transformer import lm_logits


def make_prefill_step(cfg: ModelConfig, *, impl: str = None) -> Callable:
    """(model, batch) -> last-position logits [B, vocab] (f32)."""

    @torch.no_grad()
    def prefill_step(model, batch):
        hidden = model_forward(cfg, model, batch, impl=impl)
        return lm_logits(cfg, model, hidden[:, -1:])[:, 0]

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """(model, cache, token) -> (logits [B, vocab], new cache)."""

    @torch.no_grad()
    def serve_step(model, cache, token):
        return model_decode_step(cfg, model, cache, token)

    return serve_step
