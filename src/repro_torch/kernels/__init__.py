"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (the CPU path and the yardstick on the card):

* affinity — the paper's batched valid() scheduling matrix and the fused
  bulk decide pass (CUDA C++, ``affinity/csrc/``)
* flash_attention — the causal / sliding-window GQA attention forward of
  the model-serving path (CUDA C++, ``flash_attention/csrc/``)
* mamba_scan — the mamba-1 selective scan of the SSM prefill (CUDA C++,
  ``mamba_scan/csrc/``)
"""
