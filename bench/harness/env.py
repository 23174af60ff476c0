"""The run's surroundings: cache directories inside the checkout, the look
for enough cards, and the check that the process never loaded JAX."""
from __future__ import annotations

import os
import sys
from pathlib import Path

#: top-level module names the process that prints a result may not hold:
#: JAX, its libraries, and the JAX package this port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def pin_caches(root: Path) -> None:
    """Every build and kernel cache a run might write, at fixed paths in the
    checkout's ``build/`` (the port's own nvcc libraries go to
    ``build/repro_torch``, fixed in its code).  Set before torch is
    imported."""
    cache = root / "build" / "bench-cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)


def forbidden_modules() -> list:
    """Names in ``sys.modules`` whose top-level name (the part before the
    first dot, compared whole) is forbidden: ``repro_torch`` is not
    ``repro``."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in FORBIDDEN)


def require_cards(n: int):
    """The torch module, once it is known that ``n`` CUDA cards are there;
    exits with code 2 (and no result) otherwise."""
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("no CUDA device: the benchmark measures the port on "
                         "an NVIDIA GPU and prints no result without one\n")
        raise SystemExit(2)
    if torch.cuda.device_count() < n:
        sys.stderr.write(f"the cell needs {n} CUDA devices, "
                         f"{torch.cuda.device_count()} are visible\n")
        raise SystemExit(2)
    return torch
