"""flash_roofline (device trace): the least time every causal attention
call of the profiled requests could take (its useful FLOPs at the bf16
peak: ``harness/flops.py``) over the bf16 flash kernel's device time in
the span.  Nothing to read in a family without attention, or where the
kernel did not run."""
from bench.harness import flops

#: the bf16 flash kernel's name
FLASH = "flash_fwd_bf16_sm90"


def read(ctx):
    s = ctx.trace
    layers, heads, hd = ctx.family.attention_shape(ctx.config)
    if s is None or layers == 0:
        return None
    t = sum(d for n, d in s.kernels() if FLASH in n)
    if t <= 0:
        return None
    bound = sum(layers * flops.flash_bound_s(r.length, heads, hd)
                for r in ctx.records if r.index in s.requests)
    return 100.0 * bound / t
