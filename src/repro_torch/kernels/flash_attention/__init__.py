"""Causal / sliding-window / non-causal GQA flash attention: a CUDA kernel
for CUDA tensors (bf16 on the tensor cores, float32 on the CUDA cores), the
plain PyTorch version for CPU tensors."""
from .kernel import KERNEL as FLASH_ATTENTION_KERNEL
from .kernel import KERNEL_BF16 as FLASH_ATTENTION_BF16_KERNEL
from .kernel import choose_kernel
from .ops import flash_attention
from .ref import flash_attention_ref

#: every CUDA kernel of the family, for building them together and reading
#: their launch counts
KERNELS = (FLASH_ATTENTION_KERNEL, FLASH_ATTENTION_BF16_KERNEL)

__all__ = ["flash_attention", "flash_attention_ref",
           "FLASH_ATTENTION_KERNEL", "FLASH_ATTENTION_BF16_KERNEL", "KERNELS",
           "choose_kernel"]
