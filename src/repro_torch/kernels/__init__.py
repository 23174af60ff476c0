"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (the CPU path and the yardstick on the card):

* affinity — the paper's batched valid() scheduling matrix and the fused
  bulk decide pass (CUDA C++, ``affinity/csrc/``)
* flash_attention — the causal / sliding-window GQA attention forward of
  the model-serving path (CUDA C++, ``flash_attention/csrc/``)
* mamba_scan — the mamba-1 selective scan of the SSM prefill, with a
  second entry that folds the block's elementwise chain around it, and the
  block's causal conv (CUDA C++, ``mamba_scan/csrc/``)
"""
import torch


def refuse_autograd(name: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd is recording and an input requires grad: the
    kernels (and, for agreement across devices, their plain versions
    behind the same entry) are forward-only, so their output would carry no
    ``grad_fn`` and a training graph through them would silently give no
    gradient upstream."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is forward-only (the kernel has no backward): call it "
            "under torch.no_grad(), or train through the model's plain "
            "attention path (cfg.attn_impl)")


def refuse_dtensors(name: str, *tensors: torch.Tensor) -> None:
    """Raise on a DTensor input: the mamba block's kernels (and their plain
    versions behind the same entry) take plain tensors, and the sharded step
    runs the block's plain path (``scan_impl="chunked"``)."""
    from torch.distributed.tensor import DTensor

    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(
            f"{name} takes plain tensors, not DTensors: the sharded step "
            "runs the SSM block's plain path (scan_impl='chunked')")
