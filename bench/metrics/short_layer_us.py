"""short_layer_us (host clock): the mean host microseconds of one
``model.layer`` span of the port's prefill step (``harness/
program_spans.py``), over the profiled requests under ``SHORT`` tokens:
those the host paces, where a layer's span is the time its launches take
to enqueue."""
from bench.harness import program_spans

#: prompts shorter than this are paced by the host's launches (PERF.md)
SHORT = 1024


def read(ctx):
    short = {r.index for r in ctx.records if r.profiled and r.length < SHORT}
    got = [t for i, rows in program_spans.by_request(ctx).items()
           if i in short for n, t in rows if n == "model.layer"]
    return sum(got) / len(got) * 1e6 if got else None
