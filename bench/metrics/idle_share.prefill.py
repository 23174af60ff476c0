"""idle_share.prefill (device trace): the share of the profiled span in
which no operation ran on the device: 1 - busy / span, the busy time being
the union of the device intervals of the profiler's trace and the span
its length on the host's clock."""


def read(ctx):
    s = ctx.trace
    if s is None or not s.ops:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
