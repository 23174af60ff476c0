"""Causal / sliding-window / non-causal GQA flash attention: the CUDA kernel
for CUDA tensors, the plain PyTorch version for CPU tensors."""
from .kernel import KERNEL as FLASH_ATTENTION_KERNEL
from .ops import flash_attention
from .ref import flash_attention_ref

#: every CUDA kernel of the family, for building them together and reading
#: their launch counts
KERNELS = (FLASH_ATTENTION_KERNEL,)

__all__ = ["flash_attention", "flash_attention_ref",
           "FLASH_ATTENTION_KERNEL", "KERNELS"]
