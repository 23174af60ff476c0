"""Metrics registry — counters, gauges, fixed-bucket latency histograms.

One :class:`MetricsRegistry` is the single sink every layer reports into:
``PoolMetrics`` registers its snapshot as a collector, the scheduling
sessions expose their data-plane counters, the simulator its event-engine
counters, the forecast planner its per-epoch action counts.  Two read
surfaces: :meth:`MetricsRegistry.snapshot` (one flat dict, the shape
benchmarks serialise) and :meth:`MetricsRegistry.render` (Prometheus-style
text exposition).

Histograms are *fixed-bucket*: geometric bounds spanning 1us..~56s, so
p50/p95/p99 come from cumulative bucket counts with linear interpolation —
no sample storage, O(#buckets) memory forever.  That is what lets the
profiling hooks (:class:`StageTimers`) run on the scheduler hot path: an
``observe`` is a bisect + three integer adds.

Zero-overhead-when-disabled is structural, not a flag: layers hold a
``None`` tracer/timer reference until an :class:`repro_torch.obs.Obs` bundle is
attached, and the hot paths guard with a single ``is not None`` check
(``benchmarks/overhead.py --obs`` pins the disabled tax under 1%).
"""
from __future__ import annotations

from bisect import bisect_left
from typing import Callable, Dict, List, Optional, Sequence, Tuple

#: default histogram bounds: quarter-decade geometric ladder, 1us .. ~56s
#: (32 buckets + overflow) — wide enough for both stage timers (sub-ms)
#: and end-to-end invocation latencies (seconds).
LATENCY_BOUNDS_S: Tuple[float, ...] = tuple(
    1e-6 * (10.0 ** (i / 4.0)) for i in range(32))


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """Fixed-bucket histogram with interpolated quantiles.

    ``counts[i]`` holds observations with ``x <= bounds[i]`` (and
    ``counts[-1]`` the overflow above the last bound).  ``quantile`` walks
    the cumulative counts and interpolates linearly inside the bucket —
    exact to within one bucket width, which at quarter-decade resolution is
    a ~78% relative band (plenty for p50/p95/p99 ops dashboards)."""

    __slots__ = ("name", "bounds", "counts", "count", "sum")

    def __init__(self, name: str, bounds: Optional[Sequence[float]] = None):
        self.name = name
        self.bounds: Tuple[float, ...] = (
            tuple(bounds) if bounds is not None else LATENCY_BOUNDS_S)
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0

    def observe(self, x: float) -> None:
        self.counts[bisect_left(self.bounds, x)] += 1
        self.count += 1
        self.sum += x

    def quantile(self, q: float) -> float:
        """Interpolated q-quantile (0 < q <= 1); 0.0 when empty."""
        if not self.count:
            return 0.0
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c and cum + c >= target:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) else self.bounds[-1]
                return lo + (hi - lo) * ((target - cum) / c)
            cum += c
        return self.bounds[-1]

    def snapshot(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "sum": round(self.sum, 9),
            "p50": round(self.quantile(0.50), 9),
            "p95": round(self.quantile(0.95), 9),
            "p99": round(self.quantile(0.99), 9),
        }


def _prom_name(name: str) -> str:
    return "".join(c if (c.isalnum() or c == "_") else "_" for c in name)


class MetricsRegistry:
    """Name-keyed counters/gauges/histograms plus snapshot-time collectors.

    A *collector* is a zero-argument callable returning a flat(ish) dict;
    it is invoked only at :meth:`snapshot`/:meth:`render` time, which is how
    existing counter owners (``PoolMetrics``, session ``stats`` dicts, the
    simulator) register into the plane without paying anything on their hot
    paths — their native counters stay plain attributes/dict slots."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._collectors: List[Tuple[str, Callable[[], Dict]]] = []

    # ---- instrument factories (get-or-create) ----------------------------- #

    def counter(self, name: str) -> Counter:
        got = self._counters.get(name)
        if got is None:
            got = self._counters[name] = Counter(name)
        return got

    def gauge(self, name: str) -> Gauge:
        got = self._gauges.get(name)
        if got is None:
            got = self._gauges[name] = Gauge(name)
        return got

    def histogram(self, name: str,
                  bounds: Optional[Sequence[float]] = None) -> Histogram:
        got = self._histograms.get(name)
        if got is None:
            got = self._histograms[name] = Histogram(name, bounds)
        return got

    def register_collector(self, prefix: str,
                           fn: Callable[[], Dict]) -> None:
        """Register ``fn`` to be polled at snapshot time; its keys appear as
        ``<prefix>.<key>``.  Re-registering a prefix replaces the old one
        (a platform rebuilt over the same registry must not double-report)."""
        self._collectors = [(p, f) for p, f in self._collectors if p != prefix]
        self._collectors.append((prefix, fn))

    # ---- read surfaces ----------------------------------------------------- #

    @staticmethod
    def _flatten(prefix: str, d: Dict, out: Dict[str, float]) -> None:
        for k, v in d.items():
            key = f"{prefix}.{k}"
            if isinstance(v, dict):
                MetricsRegistry._flatten(key, v, out)
            else:
                out[key] = v

    def snapshot(self) -> Dict[str, float]:
        """One flat ``name -> value`` dict: counters and gauges verbatim,
        histograms as ``<name>.count/.sum/.p50/.p95/.p99``, collector dicts
        flattened under their prefix (nested dicts dot-joined)."""
        out: Dict[str, float] = {}
        for name, c in self._counters.items():
            out[name] = c.value
        for name, g in self._gauges.items():
            out[name] = g.value
        for name, h in self._histograms.items():
            for k, v in h.snapshot().items():
                out[f"{name}.{k}"] = v
        for prefix, fn in self._collectors:
            self._flatten(prefix, fn(), out)
        return out

    def render(self) -> str:
        """Prometheus text exposition of :meth:`snapshot`.  Dots map to
        underscores; histograms emit the conformant exposition — cumulative
        ``<name>_bucket{le="<bound>"}`` rows (closed with ``le="+Inf"``)
        plus ``_sum`` and ``_count`` — so a real scrape target could compute
        ``histogram_quantile`` server-side instead of trusting our
        interpolation."""
        lines: List[str] = []
        for name, c in self._counters.items():
            n = _prom_name(name)
            lines.append(f"# TYPE {n} counter")
            lines.append(f"{n} {c.value}")
        for name, g in self._gauges.items():
            n = _prom_name(name)
            lines.append(f"# TYPE {n} gauge")
            lines.append(f"{n} {g.value}")
        for name, h in self._histograms.items():
            n = _prom_name(name)
            lines.append(f"# TYPE {n} histogram")
            cum = 0
            for bound, count in zip(h.bounds, h.counts):
                cum += count
                lines.append(f'{n}_bucket{{le="{bound}"}} {cum}')
            lines.append(f'{n}_bucket{{le="+Inf"}} {h.count}')
            lines.append(f"{n}_sum {h.sum}")
            lines.append(f"{n}_count {h.count}")
        for prefix, fn in self._collectors:
            flat: Dict[str, float] = {}
            self._flatten(prefix, fn(), flat)
            for k, v in flat.items():
                if isinstance(v, (int, float)) and v is not True and v is not False:
                    lines.append(f"{_prom_name(k)} {v}")
        return "\n".join(lines) + "\n"


class StageTimers:
    """Wall-clock stage timers for the session hot path (mask build,
    strategy select, shard route, state delta apply).

    Holders keep a ``None`` reference when profiling is off — the fast path
    is one attribute load + ``is not None``.  When on, stages are *sampled*
    1-in-``sample`` (deterministic round-robin counter, no rng — bit-
    identity with timers off is preserved): call sites ask :meth:`sample`
    *before* taking timestamps, so the unsampled passes pay one cheap
    counter tick instead of two clock reads + a histogram insert.  That is
    what keeps the enabled scheduler hot path under the 5% budget
    (``overhead.py --obs``).  Each stage feeds one fixed-bucket histogram
    (``sched.stage.<stage>_s``) — quantiles without storing samples; counts
    reflect *sampled* observations.  Wall time deliberately lives only in
    histograms, never in trace records: trace exports stay deterministic
    under the simulator's virtual clock."""

    def __init__(self, registry: MetricsRegistry,
                 prefix: str = "sched.stage", sample: int = 128):
        if sample < 1 or (sample & (sample - 1)):
            raise ValueError("sample must be a power of two")
        self.registry = registry
        self.prefix = prefix
        self.mask = sample - 1
        self.tick = 0
        self._hist: Dict[str, Histogram] = {}

    def sample(self) -> bool:
        """Deterministic 1-in-``sample`` gate; call before timestamping.
        ``tick``/``mask`` are public so the hottest call sites can inline
        this counter advance and skip the method call."""
        t = (self.tick + 1) & self.mask
        self.tick = t
        return t == 0

    def observe(self, stage: str, dt: float) -> None:
        h = self._hist.get(stage)
        if h is None:
            h = self.registry.histogram(f"{self.prefix}.{stage}_s")
            self._hist[stage] = h
        h.observe(dt)
