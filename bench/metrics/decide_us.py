"""decide_us (host clock): the mean host microseconds a profiled request
spends deciding where it runs, read from the port's own spans
(``harness/program_spans.py``): ``engine.policy`` (the request's
synthesised Listing-1 policy, with the forecast's observation) plus
``engine.schedule`` (``try_schedule``: ``affinity_valid`` on the card and
its result read back)."""
from bench.harness import program_spans

NAMES = ("engine.policy", "engine.schedule")


def read(ctx):
    return program_spans.mean_per_request_us(ctx, NAMES)
