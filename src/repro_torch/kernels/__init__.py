"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (the CPU path and the yardstick on the card):

* affinity — the paper's batched valid() scheduling matrix and the fused
  bulk decide pass (CUDA C++, ``affinity/csrc/``)
* flash_attention — the causal / sliding-window GQA attention forward of
  the model-serving path (CUDA C++, ``flash_attention/csrc/``)

The reference's mamba-scan Pallas kernel belongs to the SSM/hybrid slice
(``ROADMAP.md``, Queue 2).
"""
