"""Unified observability plane: metrics registry, decision tracing, stage
profiling, latency attribution, SLO burn-rate accounting — one
:class:`Obs` bundle threaded through all four layers (Platform facade →
scheduling session / zone shards → warm pool → simulator).

Zero-overhead-when-disabled: layers hold ``None`` tracer/timer references
until an ``Obs`` is attached, so the hot paths pay one ``is not None``
check (gated by ``benchmarks/overhead.py --obs``: disabled < 1% on the
facade cycle, enabled < 5% on the session decision path).

Quick start::

    from repro_torch.obs import Obs, SloEngine
    from repro_torch.platform import Platform

    obs = Obs.enabled(slo=SloEngine({"api": 0.5}))  # tracer + timers + SLO
    plat = Platform.from_yaml(SCRIPT, cluster=..., obs=obs)
    ... invoke/complete ...
    print(obs.render())                       # Prometheus-style exposition
    timeline = obs.tracer.chrome_trace()      # open in ui.perfetto.dev
"""
from __future__ import annotations

from typing import Optional

from .metrics import (
    Counter,
    Gauge,
    Histogram,
    LATENCY_BOUNDS_S,
    MetricsRegistry,
    StageTimers,
)
from .trace import RECORD_FIELDS, Tracer, validate_chrome_trace
from .attribution import (
    COMPONENTS,
    LatencyAttributor,
    build as build_attribution,
    check as check_attribution,
    summarize as summarize_attribution,
)
from .slo import SloEngine, SloObjective
from . import schema

__all__ = [
    "Obs", "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "StageTimers", "Tracer", "validate_chrome_trace", "RECORD_FIELDS",
    "LATENCY_BOUNDS_S", "schema",
    "COMPONENTS", "LatencyAttributor", "build_attribution",
    "check_attribution", "summarize_attribution",
    "SloEngine", "SloObjective",
]


class Obs:
    """The observability bundle: one :class:`MetricsRegistry` (always
    present — collectors are snapshot-time-only and free on the hot path),
    an optional :class:`Tracer`, optional :class:`StageTimers`, an optional
    :class:`SloEngine` with per-function latency objectives.

    ``Obs()`` is the disabled shape: layers attach their counters as
    collectors but record no traces and time no stages."""

    def __init__(self, *, registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None, timers: bool = False,
                 slo: Optional[SloEngine] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer
        self.timers = StageTimers(self.registry) if timers else None
        self.slo = slo
        if tracer is not None:
            self.registry.register_collector("tracer", lambda: {
                "records": len(tracer), "dropped_spans": tracer.dropped_spans})
        if slo is not None:
            slo.register_into(self.registry)

    @classmethod
    def enabled(cls, *, capacity: int = 65536, verdicts: bool = False,
                timers: bool = True,
                slo: Optional[SloEngine] = None) -> "Obs":
        """Tracing on: ring of ``capacity`` records, per-block verdict
        capture when ``verdicts`` (the explain-agreement surface, off the
        perf budget), stage timers unless disabled, plus an optional SLO
        engine registered as a snapshot collector."""
        return cls(tracer=Tracer(capacity=capacity, verdicts=verdicts),
                   timers=timers, slo=slo)

    def snapshot(self):
        return self.registry.snapshot()

    def render(self) -> str:
        return self.registry.render()
