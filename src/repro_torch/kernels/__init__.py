"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (the CPU path and the yardstick on the card):

* affinity — the paper's batched valid() scheduling matrix and the fused
  bulk decide pass (CUDA C++, ``affinity/csrc/``)

The reference's flash-attention and mamba-scan Pallas kernels serve the
model stack, a later slice (``ROADMAP.md``, Queue 2).
"""
