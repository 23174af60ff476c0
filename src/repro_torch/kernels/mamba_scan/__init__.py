"""The mamba-1 selective scan: the CUDA kernel for CUDA tensors, the plain
PyTorch version for CPU tensors."""
from .kernel import KERNEL as SELECTIVE_SCAN_KERNEL
from .ops import selective_scan
from .ref import selective_scan_ref

#: every CUDA kernel of the family, for building them together and reading
#: their launch counts
KERNELS = (SELECTIVE_SCAN_KERNEL,)

__all__ = ["selective_scan", "selective_scan_ref", "SELECTIVE_SCAN_KERNEL",
           "KERNELS"]
