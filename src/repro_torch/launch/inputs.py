"""``meta``-tensor stand-ins for every model input per (arch x shape):
the right shapes and dtypes, nothing allocated (for the dry run)."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import encdec as ed
from repro_torch.models import transformer as tf
from repro_torch.models.layers import dtype_of


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_struct(cfg: ModelConfig, shape: ShapeSpec, *,
                 with_labels: bool) -> Dict[str, Any]:
    """Inputs for train_step / prefill_step (token ids and labels int32,
    as the reference's)."""
    S, B = shape.seq_len, shape.global_batch
    dt = dtype_of(cfg.dtype)
    ids = torch.int32
    if cfg.family == "encdec":
        half = S // 2
        out = {"frames": _meta((B, half, cfg.frontend_dim), dt),
               "tokens": _meta((B, half), ids)}
        if with_labels:
            out["labels"] = _meta((B, half), ids)
        return out
    if cfg.frontend == "vision":
        text = S - cfg.n_patches
        out = {"patches": _meta((B, cfg.n_patches, cfg.frontend_dim), dt),
               "tokens": _meta((B, text), ids)}
        if with_labels:
            out["labels"] = _meta((B, text), ids)
        return out
    out = {"tokens": _meta((B, S), ids)}
    if with_labels:
        out["labels"] = _meta((B, S), ids)
    return out


def decode_struct(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[Any, Any]:
    """(token, cache) for serve_step: one new token against a KV/state
    cache of length seq_len."""
    S, B = shape.seq_len, shape.global_batch
    token = _meta((B, 1), torch.int32)
    if cfg.family == "encdec":
        half = S // 2
        cache = ed.encdec_init_cache(cfg, B, half, half, device="meta")
    else:
        cache = tf.init_cache(cfg, B, S, device="meta")
    return token, cache


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """All inputs for the step implied by the shape kind."""
    if shape.kind == "train":
        return {"batch": batch_struct(cfg, shape, with_labels=True)}
    if shape.kind == "prefill":
        return {"batch": batch_struct(cfg, shape, with_labels=False)}
    token, cache = decode_struct(cfg, shape)
    return {"token": token, "cache": cache}
