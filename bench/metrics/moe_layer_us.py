"""moe_layer_us (host clock): the mean host microseconds of one
``model.moe`` span (the port's MoE FFN call, inside its layer:
``harness/program_spans.py``), over the profiled requests under 1,024
tokens, those the host paces, as ``short_layer_us`` reads
``model.layer``.  Nothing to read where the program records no such
span."""
from bench.harness import program_spans

#: prompts shorter than this are paced by the host's launches (PERF.md)
SHORT = 1024


def read(ctx):
    short = {r.index for r in ctx.records if r.profiled and r.length < SHORT}
    got = [t for i, rows in program_spans.by_request(ctx).items()
           if i in short for n, t in rows if n == "model.moe"]
    return sum(got) / len(got) * 1e6 if got else None
