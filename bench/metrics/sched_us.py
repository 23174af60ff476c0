"""sched_us (host clock): the mean host microseconds a request spends in
the serving engine and its decision path, outside the runner: the wall
time of ``Engine.submit`` less the runner's own time as the engine
measured it (policy synthesis, ``try_schedule`` with ``affinity_valid`` on
the card, allocation, completion), over the window's requests (a traced
run profiles a span after the window)."""


def read(ctx):
    rows = [r.wall - r.latency for r in ctx.window]
    return sum(rows) / len(rows) * 1e6 if rows else None
