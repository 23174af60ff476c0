"""The batched Listing-1 ``valid()`` matrix and the fused bulk decide pass:
CUDA kernels for CUDA tensors, plain PyTorch versions for CPU tensors, and
the float64 numpy twins the session's ``np`` backend runs."""
from .bulk_kernel import KERNEL as BULK_DECIDE_KERNEL
from .bulk_np import (CONGESTION_S, LIFECYCLE_S, STRATEGY_CODES,
                      bulk_argmin_np, bulk_decide_ref_np, bulk_scores_np)
from .bulk_ops import bulk_decide, bulk_decide_np
from .bulk_ref import bulk_decide_ref
from .kernel import KERNEL as AFFINITY_VALID_KERNEL
from .ops import affinity_valid, affinity_valid_np, resolve_device
from .ref import affinity_valid_ref
from .ref_np import NO_CAP, NO_CONC, affinity_valid_ref_np

#: every CUDA kernel of the family, for building them together and reading
#: their launch counts
KERNELS = (AFFINITY_VALID_KERNEL, BULK_DECIDE_KERNEL)

__all__ = ["affinity_valid", "affinity_valid_np", "affinity_valid_ref",
           "affinity_valid_ref_np", "bulk_decide", "bulk_decide_np",
           "bulk_decide_ref", "bulk_decide_ref_np", "bulk_scores_np",
           "bulk_argmin_np", "STRATEGY_CODES", "LIFECYCLE_S",
           "CONGESTION_S", "NO_CAP", "NO_CONC", "resolve_device",
           "AFFINITY_VALID_KERNEL", "BULK_DECIDE_KERNEL", "KERNELS"]
