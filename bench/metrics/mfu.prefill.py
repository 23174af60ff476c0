"""mfu.prefill (host clock): the useful model FLOPs of every request the
window completed (``harness/flops.py``: the family's matrix parameters a
token passes, the LM head once, causal attention's useful FLOPs) over the
window's span, as a share of one H100's bf16 peak.  A traced run profiles
a span after the window, so the window is the same as in an untraced
run."""
from bench.harness import flops, peaks


def read(ctx):
    work = sum(flops.prefill_flops(ctx.family, ctx.config, r.length)
               for r in ctx.window if r.ok)
    return 100.0 * work / ctx.span_s / peaks.BF16_FLOPS
