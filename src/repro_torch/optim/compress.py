"""int8 gradient compression with error feedback, as the reference's
``optim/compress.py``.

Quantising gradients to int8 with a per-tensor scale cuts a gradient
all-reduce's traffic 4x against float32, while error feedback keeps the
*accumulated* quantisation error bounded.  The compressor is a pure
transformation of the gradients: q = round(g / s); decoding feeds the
residual (g - s q) forward into the next step through a state slot in the
optimizer state, ``opt_state["compress"]["ef"]``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class GradCompressor:
    enabled: bool = True
    bits: int = 8

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        # zeros_like: a DTensor parameter's local shard, not its global
        # shape on every rank
        return {"ef": {k: torch.zeros_like(
            p, dtype=torch.float32, memory_format=torch.contiguous_format)
            for k, p in params.items()}}

    @torch.no_grad()
    def apply(self, grads: Mapping[str, torch.Tensor], opt_state
              ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        """Quantise and dequantise the gradients (the collective would run
        on the int8 payload), carrying the residual by error feedback."""
        if not self.enabled:
            return grads, opt_state
        ef = opt_state["compress"]["ef"]
        qmax = 2.0 ** (self.bits - 1) - 1
        new_g, new_e = {}, {}
        for k, g in grads.items():
            g = g.float() + ef[k]
            scale = torch.clamp(g.abs().max(), min=1e-12) / qmax
            q = torch.round(g / scale).to(torch.int8)
            new_g[k] = q.float() * scale
            new_e[k] = g - new_g[k]
        return new_g, {**opt_state, "compress": {"ef": new_e}}
