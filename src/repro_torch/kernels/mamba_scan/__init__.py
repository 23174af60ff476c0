"""The mamba-1 block's kernels: the selective scan (and its second entry,
the scan with the block's elementwise chain around it) and the causal conv
with its bias and SiLU.  The CUDA kernels for CUDA tensors, the plain
PyTorch versions for CPU tensors."""
from .kernel import CONV_KERNEL as CAUSAL_CONV_KERNEL
from .kernel import FUSED_KERNEL as SELECTIVE_SCAN_FUSED_KERNEL
from .kernel import KERNEL as SELECTIVE_SCAN_KERNEL
from .ops import causal_conv_silu, selective_scan, selective_scan_fused
from .ref import (causal_conv_silu_ref, selective_scan_fused_ref,
                  selective_scan_ref)

#: every CUDA kernel of the family, for building them together and reading
#: their launch counts
KERNELS = (SELECTIVE_SCAN_KERNEL, SELECTIVE_SCAN_FUSED_KERNEL,
           CAUSAL_CONV_KERNEL)

__all__ = ["selective_scan", "selective_scan_ref", "selective_scan_fused",
           "selective_scan_fused_ref", "causal_conv_silu",
           "causal_conv_silu_ref", "SELECTIVE_SCAN_KERNEL",
           "SELECTIVE_SCAN_FUSED_KERNEL", "CAUSAL_CONV_KERNEL", "KERNELS"]
