"""Family dispatch: one entry point per model operation.  The dense and vlm
families run; the ssm, hybrid and moe families raise
``NotImplementedError`` until the SSM/hybrid slice, and enc-dec until its
own slice (``ROADMAP.md``)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.affinity.ops import resolve_device

from . import transformer as tf

ENCDEC_NOT_PORTED = ("the encoder-decoder family is not ported yet: it comes "
                     "with the enc-dec slice (ROADMAP.md, Queue 1: "
                     "models/encdec.py)")


def _lm_only(cfg: ModelConfig) -> None:
    if cfg.family == "encdec":
        raise NotImplementedError(ENCDEC_NOT_PORTED)


def init_model(cfg: ModelConfig, generator: torch.Generator,
               device="cuda") -> tf.LM:
    """The model's parameters, drawn on ``device`` (the card unless the
    caller asks for ``"cpu"``) from ``generator``, which must live there
    too.  The values are the port's own; ``repro_torch.convert.
    lm_params_from_jax`` loads the reference's instead."""
    _lm_only(cfg)
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"the generator lives on {generator.device}, the "
                         f"weights are drawn on {dev}")
    return tf.init_lm(cfg, generator, dev)


def model_forward(cfg: ModelConfig, model, batch, *, impl=None):
    _lm_only(cfg)
    return tf.lm_forward(cfg, model, batch, impl=impl)


def init_cache(cfg: ModelConfig, B: int, max_len: int, *, device="cuda"):
    _lm_only(cfg)
    return tf.init_cache(cfg, B, max_len, device=resolve_device(device))


def model_decode_step(cfg: ModelConfig, model, cache, token):
    _lm_only(cfg)
    return tf.lm_decode_step(cfg, model, cache, token)

