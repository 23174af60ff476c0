"""ttft_p90_ms (host clock): the 90th percentile, by nearest rank over
every request of the window, of the time from ``Engine.submit`` to its
return: the placement decision, the prefill and the last position's
logits on the host, which is what a first token waits for.  A request
that failed counts with the time it took."""
import math


def nearest_rank(values, q: float) -> float:
    """The smallest value with at least a share q of all values at or
    below it: p90 of 100 values is the 90th smallest, 10 beyond it."""
    xs = sorted(values)
    return xs[max(0, math.ceil(q * len(xs)) - 1)]


def read(ctx):
    return nearest_rank([r.wall for r in ctx.window], 0.9) * 1e3
