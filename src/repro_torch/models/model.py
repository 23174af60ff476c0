"""Family dispatch: one entry point per model operation, as the reference's
``models/model.py``.  The enc-dec family goes to :mod:`.encdec`, every other
family (dense, moe, ssm, hybrid, vlm) to :mod:`.transformer`."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, param_counts
from repro_torch.kernels.affinity.ops import resolve_device

from . import encdec as ed
from . import transformer as tf


def init_model(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    """The model's parameters, drawn on ``device`` (the card unless the
    caller asks for ``"cpu"``) from ``generator``, which must live there
    too.  The values are the port's own; ``repro_torch.convert.
    model_params_from_jax`` loads the reference's instead."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"the generator lives on {generator.device}, the "
                         f"weights are drawn on {dev}")
    if cfg.family == "encdec":
        return ed.init_encdec(cfg, generator, dev)
    return tf.init_lm(cfg, generator, dev)


def model_forward(cfg: ModelConfig, model, batch, *, impl=None):
    if cfg.family == "encdec":
        return ed.encdec_forward(cfg, model, batch, impl=impl)
    return tf.lm_forward(cfg, model, batch, impl=impl)


def model_loss(cfg: ModelConfig, model, batch, *, impl=None):
    hidden = model_forward(cfg, model, batch, impl=impl)
    labels = batch["labels"]
    if cfg.frontend == "vision":
        hidden = hidden[:, -labels.shape[1]:]  # drop patch positions
    if cfg.family == "encdec":
        return ed.encdec_loss(cfg, model, hidden, labels)
    return tf.lm_loss(cfg, model, hidden, labels)


def init_cache(cfg: ModelConfig, B: int, max_len: int, *, enc_len: int = 0,
               device="cuda"):
    dev = resolve_device(device)
    if cfg.family == "encdec":
        return ed.encdec_init_cache(cfg, B, max_len, enc_len, device=dev)
    return tf.init_cache(cfg, B, max_len, device=dev)


def model_decode_step(cfg: ModelConfig, model, cache, token):
    if cfg.family == "encdec":
        return ed.encdec_decode_step(cfg, model, cache, token)
    return tf.lm_decode_step(cfg, model, cache, token)


def model_flops_per_token(cfg: ModelConfig) -> float:
    """MODEL_FLOPS = 6 * N_active per token (attention flops excluded)."""
    _, active = param_counts(cfg)
    return 6.0 * active
