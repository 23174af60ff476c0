"""expert_roofline (device trace): the least time the expert products of
every MoE layer of the profiled requests could take, over the device time
of the grouped expert-product kernels in the span.  A layer's least time
over S tokens is the larger of its products' FLOPs at the bf16 peak and
the bytes they must move at 3.35 TB/s (the family's ``expert_flops`` and
``expert_bytes``, counted from the configuration): short prompts are
bound by the experts' weights, long ones by their products.  Nothing to
read in a family without experts, or where no grouped kernel ran."""
from bench.harness import peaks

#: the grouped products' kernels (``torch._grouped_mm`` on sm90: CUTLASS's
#: grouped GEMM), by the names the card's trace gives them
GROUPED = ("GroupProblemShape",)


def grouped(name: str) -> bool:
    return any(m in name for m in GROUPED)


def read(ctx):
    s, fam, cfg = ctx.trace, ctx.family, ctx.config
    if s is None or not hasattr(fam, "expert_flops"):
        return None
    t = sum(d for n, d in s.kernels() if grouped(n))
    if t <= 0:
        return None
    bound = sum(fam.moe_layers(cfg) * max(
        fam.expert_flops(cfg, r.length) / peaks.BF16_FLOPS,
        fam.expert_bytes(cfg, r.length) / peaks.HBM_BYTES)
        for r in ctx.records if r.index in s.requests)
    return 100.0 * bound / t
