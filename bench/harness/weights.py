"""The model's weights, made by the benchmark from the seed and handed to
both the program and the reference.

A family file (``reference/<family>.py``) lists its leaves: a name (``*``
stands for the layer index), the shape of one copy, how many copies (the
layers), the type it is served in, and how it is drawn.  Every leaf of one
type lives in one flat buffer on the device; the buffer is drawn from a
generator on the device in a few large calls, and each leaf is then
shaped by one call over all its copies.  So the draw takes a few calls per
leaf kind, never one per layer, and nothing is made on the host.

Inits:
``{"normal": std}``           std x N(0, 1)
``{"around": [mean, std]}``   mean + std x N(0, 1)
``{"log_arange": n}``         log(1), ..., log(n) along the last axis
``{"dt_bias": [lo, hi]}``     softplus^-1 of a log-uniform draw in [lo, hi]
``{"zeros": true}``, ``{"ones": true}``
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

#: elements drawn per call; each leaf starts on a multiple of ALIGN elements
CHUNK = 1 << 30
ALIGN = 256


@dataclasses.dataclass(frozen=True)
class Leaf:
    name: str            # e.g. "layers.*.ssm.in_proj" or "embed.tok"
    shape: Tuple[int, ...]
    copies: int          # layers for a "*" name, else 1
    dtype: str           # "bfloat16", "float32", ...
    init: dict

    @property
    def numel(self) -> int:
        return self.copies * math.prod(self.shape)

    def names(self) -> List[str]:
        if "*" not in self.name:
            return [self.name]
        return [self.name.replace("*", str(i)) for i in range(self.copies)]


def _torch_dtype(torch, name: str):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


class Weights:
    """``kinds[name]``: every copy of a leaf as one tensor [copies, *shape]
    (or [*shape] for a single copy), a view into its type's flat buffer."""

    def __init__(self, leaves: Sequence[Leaf], seed: int, device):
        import torch

        self.leaves = list(leaves)
        self.kinds: Dict[str, "torch.Tensor"] = {}
        g = torch.Generator(device=device).manual_seed(seed)
        by_type: Dict[str, List[Leaf]] = {}
        for leaf in self.leaves:
            by_type.setdefault(leaf.dtype, []).append(leaf)
        self.buffers = {}
        for dtype, group in by_type.items():
            offsets, n = [], 0
            for leaf in group:
                offsets.append(n)
                n += -(-leaf.numel // ALIGN) * ALIGN
            buf = torch.empty(n, dtype=_torch_dtype(torch, dtype),
                              device=device)
            for start in range(0, n, CHUNK):
                buf[start:start + CHUNK].normal_(generator=g)
            self.buffers[dtype] = buf
            for leaf, off in zip(group, offsets):
                shape = ((leaf.copies,) if "*" in leaf.name else ()) \
                    + tuple(leaf.shape)
                t = buf[off:off + leaf.numel].view(shape)
                _shape(torch, t, leaf.init)
                self.kinds[leaf.name] = t

    def layer(self, name: str, i: int):
        return self.kinds[name][i]

    def state_dict(self) -> dict:
        """Every leaf by the name a copy goes by (``*`` filled in)."""
        out = {}
        for leaf in self.leaves:
            t = self.kinds[leaf.name]
            if "*" in leaf.name:
                for i, n in enumerate(leaf.names()):
                    out[n] = t[i]
            else:
                out[leaf.name] = t
        return out

    def nbytes(self) -> int:
        return sum(b.numel() * b.element_size()
                   for b in self.buffers.values())


def _shape(torch, t, init: dict) -> None:
    """Turn ``t``'s standard-normal draw into the leaf's init, in place."""
    (kind, arg), = init.items()
    if kind == "normal":
        t.mul_(arg)
    elif kind == "around":
        t.mul_(arg[1]).add_(arg[0])
    elif kind == "zeros":
        t.zero_()
    elif kind == "ones":
        t.fill_(1.0)
    elif kind == "log_arange":
        t.copy_(torch.log(torch.arange(1, arg + 1, dtype=torch.float32,
                                       device=t.device)).expand(t.shape))
    elif kind == "dt_bias":
        lo, hi = math.log(arg[0]), math.log(arg[1])
        u = 0.5 * (1.0 + torch.erf(t.float() / math.sqrt(2.0)))
        dt = torch.exp(lo + u * (hi - lo))
        t.copy_(dt + torch.log(-torch.expm1(-dt)))  # softplus^-1(dt)
    else:
        raise ValueError(f"unknown init {init!r}")
