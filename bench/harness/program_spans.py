"""The port's own wall-clock spans (``repro_torch.obs.spans``), as the
per-layer readers take them.

The program records a span only while a torch profiler runs, that is in a
traced run's profiled requests.  Each span is ``(name, t0_ns, t1_ns)`` on
``time.perf_counter_ns``; the entry stamps ``t_submit`` and ``t_done`` with
``time.perf_counter``, the same clock, so a span belongs to the profiled
request whose interval holds it.  A program without the span ring, or one
whose ring dropped spans (a request's spans would be incomplete), gives
nothing to read.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple


def program_spans():
    """The ring's spans, or ``None`` where the program has no ring or the
    ring dropped some."""
    try:
        from repro_torch.obs import spans
    except ImportError:
        return None
    if spans.dropped():
        return None
    return spans.records()


def by_request(ctx) -> Dict[int, List[Tuple[str, float]]]:
    """``{record index: [(span name, seconds), ...]}`` over the profiled
    requests that hold at least one span."""
    rows = program_spans()
    recs = sorted((r for r in ctx.records if r.profiled),
                  key=lambda r: r.t_submit)
    if not rows or not recs:
        return {}
    starts = [r.t_submit for r in recs]
    out: Dict[int, List[Tuple[str, float]]] = {}
    for name, t0, t1 in rows:
        s, e = t0 * 1e-9, t1 * 1e-9
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and e <= recs[i].t_done:
            out.setdefault(recs[i].index, []).append((name, e - s))
    return out


def mean_per_request_us(ctx, names) -> Optional[float]:
    """Mean host microseconds a profiled request spends in the spans
    ``names`` (summed), or ``None`` without spans."""
    got = by_request(ctx)
    if not got:
        return None
    per = [sum(t for n, t in rows if n in names) for rows in got.values()]
    return sum(per) / len(per) * 1e6
