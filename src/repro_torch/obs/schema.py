"""The one place operational snapshot dicts get their shape.

Before the observability plane, three consumers each hand-rolled their own
stats dict: ``PoolMetrics.snapshot`` (serialised into
``BENCH_coldstart.json``), ``Platform.stats`` (session counters + zone
rollups + pool), and ``serve.Engine.forecast_stats``.  They now all build
here, so the shapes stay consistent and a key rename happens exactly once.

Bit-compat contract: :func:`pool_snapshot` reproduces the historical
``PoolMetrics.snapshot()`` dict *exactly* — same keys, same order, same
``round(..., 6)`` — because ``BENCH_coldstart.json`` must stay
bit-identical across the migration (asserted by regeneration in the PR
that introduced this module).
"""
from __future__ import annotations

from typing import Dict

#: the BENCH_coldstart.json counter vocabulary, in serialisation order
POOL_SNAPSHOT_KEYS = (
    "cold_starts", "warm_hits", "hot_hits", "total_starts",
    "cold_start_rate", "warm_hit_rate",
    "evictions_ttl", "evictions_pressure", "evictions_planned",
    "unpooled_starts", "start_seconds",
    "prewarm_starts", "prewarm_hits", "prewarm_wasted",
    "prewarm_waste_ratio", "migrations",
    "prewarm_seconds", "migration_seconds",
)


def pool_snapshot(m) -> Dict[str, float]:
    """The canonical pool-metrics dict (``m`` is a
    :class:`repro.pool.metrics.PoolMetrics`)."""
    return {
        "cold_starts": m.cold_starts,
        "warm_hits": m.warm_hits,
        "hot_hits": m.hot_hits,
        "total_starts": m.total_starts,
        "cold_start_rate": round(m.cold_start_rate, 6),
        "warm_hit_rate": round(m.warm_hit_rate, 6),
        "evictions_ttl": m.evictions_ttl,
        "evictions_pressure": m.evictions_pressure,
        "evictions_planned": m.evictions_planned,
        "unpooled_starts": m.unpooled_starts,
        "start_seconds": round(m.start_seconds, 6),
        "prewarm_starts": m.prewarm_starts,
        "prewarm_hits": m.prewarm_hits,
        "prewarm_wasted": m.prewarm_wasted,
        "prewarm_waste_ratio": round(m.prewarm_waste_ratio, 6),
        "migrations": m.migrations,
        "prewarm_seconds": round(m.prewarm_seconds, 6),
        "migration_seconds": round(m.migration_seconds, 6),
    }


def platform_stats(platform) -> Dict:
    """The ``Platform.stats()`` dict: session data-plane counters, cluster
    shape, per-zone rollups (with idle-container residency when a pool is
    attached — the counters ``explain()`` could show but nothing
    aggregated), the pool snapshot, the worker-failure loss counter, and —
    with an active resilience bundle attached — its
    ``shed / retries / queue_depth`` block with per-tenant admission
    counters (:meth:`repro.resilience.Resilience.snapshot`)."""
    out = dict(platform.session.stats)
    out["workers"] = len(platform.state.workers())
    out["tags"] = len(platform.session.tag_index)
    if platform._sharded:
        zones = platform.session.zone_stats()
        if platform.pool is not None:
            residency: Dict[str, int] = {}
            zone_of = platform.state.zone_of
            for (w, _f), n in platform.pool.residency_counts().items():
                z = zone_of(w)
                residency[z] = residency.get(z, 0) + n
            for z, row in zones.items():
                row["pool_idle"] = residency.get(z, 0)
        out["zones"] = zones
    if platform.pool is not None:
        out["pool"] = pool_snapshot(platform.pool.metrics)
    obs = getattr(platform, "obs", None)
    if obs is not None and getattr(obs, "slo", None) is not None:
        out["slo"] = obs.slo.snapshot()
    out["lost_activations"] = getattr(platform, "lost_activations", 0)
    res = getattr(platform, "resilience", None)
    if res is not None and res.active:
        out["resilience"] = res.snapshot()
    return out


def forecast_stats(forecast, now: float, horizon: float) -> Dict[str, Dict]:
    """Per-function forecast state (``serve.Engine.forecast_stats`` shape);
    empty without an estimator."""
    if forecast is None:
        return {}
    return forecast.state(now, horizon)
