"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit).  Every roofline
and MFU share is stated against these; the card's power limit is printed
beside each run's result."""

#: bf16 / fp16 tensor-core FLOP/s
BF16_FLOPS = 989e12
#: HBM3 bytes/s
HBM_BYTES = 3.35e12
