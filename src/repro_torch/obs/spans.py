"""Wall-clock spans inside the serving engine and the model step.

``with span("engine.schedule"): ...`` marks one piece of host work.  The
switch is the torch profiler itself:

* **off** (no ``torch.profiler`` / ``torch.autograd.profiler`` recording in
  the process) the call reads one flag and returns a shared no-op context
  manager: no ``record_function``, no clock read, no allocation;
* **on** it opens ``torch.autograd.profiler.record_function(name)``, so the
  span sits in the profiler's trace on the device trace's clock (an idle
  gap on the device is labelled by the innermost span the host was in),
  and it appends ``(name, t0_ns, t1_ns)`` from ``time.perf_counter_ns()``
  to a bounded ring.  ``time.perf_counter`` reads the same clock, so a
  caller that stamps its requests with it can assign each span to the
  request whose interval holds it.

The ring keeps the newest ``CAPACITY`` spans, in the order they close (a
span closes after the spans nested in it); every eviction bumps
``dropped_spans``, as in :class:`repro_torch.obs.trace.Tracer`.  An
:class:`repro_torch.obs.Obs` attached to a platform reports both as the
``spans.records`` and ``spans.dropped`` collector keys.

Spans are not ``Tracer`` records: a tracer's exports are deterministic
under the simulator's clock and hold no wall time, while a span is wall
time by purpose.  Nothing here samples, aggregates or exports; the
profiler's Chrome trace is the timeline.

The sites and their names (readers and PERF.md use them):

* ``Engine.submit``: ``engine.health``, ``engine.policy``,
  ``engine.schedule``, ``engine.allocate``, ``engine.run``,
  ``engine.release``, ``engine.bind``;
* the prefill step: ``model.embed``, ``model.layer`` (each layer),
  ``model.moe`` (each MoE FFN, inside its layer), ``model.final_norm``,
  ``model.head``.

Under the profiler a span costs ~14 us of host time on an H100 machine's
host (the profiler's own recording of the range), so the sites stop at
the layer: six more in each of falcon-mamba-7b's 64 mamba layers would
add ~5 ms to every profiled request, which a short prompt's launches
pace.
"""
from __future__ import annotations

import time
from collections import deque
from typing import List, Tuple

import torch.autograd.profiler as _profiler

#: spans the ring holds; a falcon-mamba-7b request through the engine
#: closes 74 (7 engine, 3 model, 64 layers)
CAPACITY = 65536


class SpanRing:
    """The bounded ring of closed spans, ``(name, t0_ns, t1_ns)``."""

    def __init__(self, capacity: int = CAPACITY):
        self.events: "deque[Tuple[str, int, int]]" = deque(maxlen=capacity)
        self.dropped_spans = 0  # spans evicted by the ring bound
        self._cap = capacity

    def append(self, name: str, t0: int, t1: int) -> None:
        if len(self.events) == self._cap:
            self.dropped_spans += 1
        self.events.append((name, t0, t1))

    def clear(self) -> None:
        self.events.clear()
        self.dropped_spans = 0


#: the process's ring: the span sites are deep in the model step, where no
#: caller could hand one in
RING = SpanRing()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "rf", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        self.rf = _profiler.record_function(self.name)
        self.rf.__enter__()
        return None

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        RING.append(self.name, self.t0, time.perf_counter_ns())
        return False


def span(name: str):
    """A context manager around one piece of host work: a no-op unless a
    torch profiler is recording (module docstring)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _On(name)


def records() -> List[Tuple[str, int, int]]:
    """The ring's spans, ``(name, t0_ns, t1_ns)`` on ``perf_counter_ns``,
    in the order they closed."""
    return list(RING.events)


def dropped() -> int:
    return RING.dropped_spans


def clear() -> None:
    """Empty the ring and zero its eviction count."""
    RING.clear()
