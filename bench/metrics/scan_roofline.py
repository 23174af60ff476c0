"""scan_roofline (device trace): the least time every selective-scan call
of the profiled requests could take (its inputs read once and its output
written once at 3.35 TB/s: ``harness/flops.py``, the family's
``scan_bytes``) over the scan kernel's device time in the span.  Nothing to
read in a family without a scan, or where no scan kernel ran."""
from bench.harness import flops

#: the scan kernel's name
SCAN = "selective_scan_fwd"


def read(ctx):
    s = ctx.trace
    fam = ctx.family
    if s is None or not hasattr(fam, "scan_bytes"):
        return None
    t = sum(d for n, d in s.kernels() if SCAN in n)
    if t <= 0:
        return None
    bound = sum(fam.scan_layers(ctx.config)
                * flops.scan_bound_s(fam, ctx.config, r.length)
                for r in ctx.records if r.index in s.requests)
    return 100.0 * bound / t
