"""The model stack of the port (dense and vlm families): the same entry
points as the JAX package's ``repro.models``, on PyTorch modules."""
from .model import init_cache, init_model, model_decode_step, model_forward

__all__ = ["init_model", "model_forward", "model_decode_step", "init_cache"]
