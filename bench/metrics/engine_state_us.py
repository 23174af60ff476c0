"""engine_state_us (host clock): the mean host microseconds a profiled
request spends in the serving engine's own state, read from the port's own
spans (``harness/program_spans.py``): ``engine.health`` (the health tick),
``engine.allocate`` (the allocation, whose change feed moves the
scheduling session's tensors, and the container), ``engine.release`` (the
container's release and the completion) and ``engine.bind`` (the session's
KV residency)."""
from bench.harness import program_spans

NAMES = ("engine.health", "engine.allocate", "engine.release",
         "engine.bind")


def read(ctx):
    return program_spans.mean_per_request_us(ctx, NAMES)
