"""The model stack of the port: the same entry points as the JAX package's
``repro.models``, on PyTorch modules."""
from .model import (init_cache, init_model, model_decode_step,
                    model_flops_per_token, model_forward, model_loss)

__all__ = ["init_model", "model_forward", "model_loss", "model_decode_step",
           "init_cache", "model_flops_per_token"]
