"""A profiled span after the window, reduced to what the per-layer
metrics and the result's ``breakdown`` read: every device operation with
its name and interval, the busy time (the union of those intervals), the
span's length on the host's clock, and the longest idle gaps labelled by
what the host was doing then (the benchmark's own ``bench.*`` range
around it, and the innermost host operation under way).

The profiler's records stay in memory; nothing is written to disk.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Tuple

#: device records that are copies and fills, not kernels
NOT_KERNELS = ("memcpy", "memset")
#: longest operation name kept (kernel names carry whole template lists)
NAME = 200


@dataclasses.dataclass
class Summary:
    ops: List[Tuple[str, float, float]]  # (name, start s, end s), device
    window_s: float
    busy_s: float
    gaps: List[Tuple[str, float]]  # (label, seconds), longest first
    requests: List[int]  # indices of the window's requests in the span

    def kernels(self):
        """(name, seconds) of every kernel launch, copies and fills
        apart."""
        return [(n, e - s) for n, s, e in self.ops
                if not any(m in n.lower() for m in NOT_KERNELS)]

    def device_ops(self, top: int = 10):
        by_name = {}
        for n, s, e in self.ops:
            by_name[n] = by_name.get(n, 0.0) + (e - s)
        return sorted(([n, t] for n, t in by_name.items()),
                      key=lambda kv: -kv[1])[:top]


class Span:
    """``with Span() as span: ...`` profiles the block; ``span.summary``
    then holds its :class:`Summary` (``requests`` filled by the caller)."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._cuda = torch.cuda.is_available()
        if self._cuda:
            torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self._cuda else []))
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        if self._cuda:
            torch.cuda.synchronize()
        window = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = reduce(self._prof.events(), window)
        return False


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(events, window_s: float) -> Summary:
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in events:
        span = (e.time_range.start * 1e-6, e.time_range.end * 1e-6)
        if e.device_type == DeviceType.CUDA:
            # a record_function range shows on the device's timeline too,
            # where it covers idle time: it is no operation
            if not getattr(e, "is_user_annotation", False) and \
                    not e.name.startswith("bench."):
                dev.append((e.name[:NAME], *span))
        elif e.device_type == DeviceType.CPU:
            host.append((e.name, *span))
    merged = _union([(s, e) for _, s, e in dev])
    busy = sum(e - s for s, e in merged)
    longest = sorted(((b - a, a, b) for (_, a), (b, _)
                      in zip(merged, merged[1:])), reverse=True)[:10]
    gaps = []
    for length, a, b in longest:
        mid = (a + b) / 2
        under = [(n, s, e) for n, s, e in host if s <= mid <= e]
        outer = [n for n, s, e in sorted(under, key=lambda t: t[1])
                 if n.startswith("bench.")]
        inner = min(under, key=lambda t: t[2] - t[1])[0] if under else "-"
        gaps.append((f"{outer[0] if outer else '-'} / {inner}", length))
    return Summary(ops=dev, window_s=window_s, busy_s=busy, gaps=gaps,
                   requests=[])
