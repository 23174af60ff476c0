"""Pool observability: start-kind, eviction and forecast-action counters.

Every acquire is exactly one of cold/warm/hot.  ``cold_starts`` counts *every*
cold start, including the ``unpooled_starts`` subset whose container could not
be admitted under the worker's budget — an unpooled start is still a cold
start, so ``total_starts`` and ``cold_start_rate`` include them (pinned by a
unit test in ``tests/test_pool.py``).  Evictions are split by cause (janitor
TTL expiry, memory-pressure eviction, planner-ordered retirement).

The forecast subsystem adds its own counters: ``prewarm_starts`` containers
started speculatively, of which ``prewarm_hits`` served at least one
invocation and ``prewarm_wasted`` died unused; ``migrations`` counts idle
containers moved across workers.  ``snapshot()`` is what
``benchmarks/coldstart.py`` serialises into ``BENCH_coldstart.json`` — its
shape now lives in :func:`repro_torch.obs.schema.pool_snapshot` (one schema for
every stats consumer), and this class is the thin counter-holding view.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass
class PoolMetrics:
    cold_starts: int = 0  # ALL cold starts (the unpooled subset included)
    warm_hits: int = 0
    hot_hits: int = 0
    evictions_ttl: int = 0
    evictions_pressure: int = 0
    evictions_planned: int = 0  # planner-ordered proactive retirements
    unpooled_starts: int = 0  # cold starts that could not be admitted to the pool
    start_seconds: float = 0.0  # total start latency charged
    # forecast subsystem
    prewarm_starts: int = 0
    prewarm_hits: int = 0
    prewarm_wasted: int = 0  # prewarmed containers that died unused
    migrations: int = 0
    prewarm_seconds: float = 0.0  # background boot time spent on prewarms
    migration_seconds: float = 0.0  # background transfer time spent migrating

    @property
    def total_starts(self) -> int:
        """Every invocation start, unpooled cold starts included (they are a
        subset of ``cold_starts``, not an extra term)."""
        return self.cold_starts + self.warm_hits + self.hot_hits

    @property
    def cold_start_rate(self) -> float:
        n = self.total_starts
        return self.cold_starts / n if n else 0.0

    @property
    def warm_hit_rate(self) -> float:
        n = self.total_starts
        return (self.warm_hits + self.hot_hits) / n if n else 0.0

    @property
    def prewarm_waste_ratio(self) -> float:
        n = self.prewarm_starts
        return self.prewarm_wasted / n if n else 0.0

    def count(self, kind: str) -> None:
        if kind == "cold":
            self.cold_starts += 1
        elif kind == "warm":
            self.warm_hits += 1
        elif kind == "hot":
            self.hot_hits += 1
        else:
            raise ValueError(f"unknown start kind {kind!r}")

    def snapshot(self) -> Dict[str, float]:
        from repro_torch.obs.schema import pool_snapshot
        return pool_snapshot(self)

    def register_into(self, registry) -> None:
        """Attach this pool's counters to a
        :class:`repro_torch.obs.MetricsRegistry` as a snapshot-time collector."""
        registry.register_collector("pool", self.snapshot)
