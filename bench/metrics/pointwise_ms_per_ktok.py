"""pointwise_ms_per_ktok (device trace): device milliseconds, per 1,000
prompt tokens of the profiled requests, in kernels that are neither matrix
products nor the port's own kernels: norms, activations, casts, the conv's
taps, RoPE, softmaxes, the routing's one-hots and cumulative counts, the
elementwise work around the scan.  Copies and fills are not kernels
(``harness/trace.py``).  The classes go by kernel name, lower-cased:"""

#: matrix products: cuBLAS / cuBLASLt (Hopper's nvjet), CUTLASS
MATMUL = ("gemm", "nvjet", "xmma", "cutlass", "cublas")
#: the port's hand-written kernels: bf16 and float32 flash, the selective
#: scan, the affinity kernels (namespace ``affinity::``)
OWN = ("flash_fwd_bf16_sm90", "flash_fwd_f32", "selective_scan_fwd",
       "affinity::")


def pointwise(name: str) -> bool:
    n = name.lower()
    return not any(m in n for m in MATMUL + OWN)


def read(ctx):
    s = ctx.trace
    if s is None or not s.requests or not s.kernels():
        return None
    ms = sum(t for n, t in s.kernels() if pointwise(n)) * 1e3
    tokens = sum(r.length for r in ctx.records if r.index in s.requests)
    return ms / tokens * 1e3
