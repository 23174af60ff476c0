"""SLO engine — per-function latency objectives with error-budget burn.

The serving side of the observability plane: each function carries an
:class:`SloObjective` (*target quantile* + *latency threshold* + the
*compliance fraction* of requests that must meet it), and the engine keeps,
on the simulator's **virtual clock**:

* an SLI stream — every observed latency is classified good
  (``latency <= threshold``) or a breach;
* **sliding-window error-budget accounting** — time-bucketed good/bad
  counts over a trailing window, with the cumulative budget-remaining
  fraction ``1 - breach_rate / (1 - compliance)``;
* **multi-window burn-rate alerts** — the SRE fast/slow pattern: the burn
  rate (breach fraction over a window, divided by the error budget) is
  computed over a short *fast* window and a long *slow* window, and an
  alert fires only when **both** exceed the threshold — fast-only spikes
  are noise, slow-only burn is stale.  A burn rate of 1.0 is "exactly
  budget-exhausting pace"; >1 eats the budget early.

The engine is deliberately passive: callers (the workload driver, and the
resilience layer's admission control — :mod:`repro_torch.resilience.admission`
sheds against :meth:`SloEngine.budget_remaining` under backlog pressure)
push ``observe(function, t, latency)`` and read ``burn_rates`` /
``alerts`` / ``snapshot``.  Attached
to an :class:`repro_torch.obs.Obs` bundle it registers as a snapshot-time
collector, so burn rates and budgets flow through ``Obs.snapshot()``, the
Prometheus ``render()``, and ``Platform.stats()["slo"]`` — the
backpressure signal ROADMAP item 5 consumes.

Nothing here reads a wall clock or draws randomness: time is whatever the
caller stamps, so traced replays stay bit-identical.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, Iterable, List, Mapping, Optional, Tuple, Union

from .metrics import Histogram


@dataclasses.dataclass(frozen=True)
class SloObjective:
    """A latency objective: ``compliance`` of requests must finish within
    ``threshold_s``; ``quantile`` is the reported tail (defaults to the
    compliance point, e.g. a 99%-within-2s objective reports p99)."""

    function: str
    threshold_s: float
    compliance: float = 0.99
    quantile: Optional[float] = None

    def __post_init__(self):
        if not (0.0 < self.compliance < 1.0):
            raise ValueError("compliance must be in (0, 1) — an error "
                             "budget of zero cannot burn meaningfully")
        if self.threshold_s <= 0.0:
            raise ValueError("threshold_s must be positive")

    @property
    def target_quantile(self) -> float:
        return self.quantile if self.quantile is not None else self.compliance

    @property
    def error_budget(self) -> float:
        return 1.0 - self.compliance


ObjectiveLike = Union[SloObjective, float, Mapping[str, float]]


def _normalize(objectives: Union[Mapping[str, ObjectiveLike],
                                 Iterable[SloObjective]]
               ) -> Dict[str, SloObjective]:
    out: Dict[str, SloObjective] = {}
    if isinstance(objectives, Mapping):
        for fn, spec in objectives.items():
            if isinstance(spec, SloObjective):
                out[fn] = spec
            elif isinstance(spec, Mapping):
                out[fn] = SloObjective(function=fn, **spec)
            else:  # bare threshold in seconds
                out[fn] = SloObjective(function=fn, threshold_s=float(spec))
    else:
        for o in objectives:
            out[o.function] = o
    return out


class _FunctionSlo:
    """Per-function state: cumulative SLI counters, a latency histogram for
    the reported quantile, and the time-bucketed good/bad ring the sliding
    windows read.  Buckets are lazily evicted past the slow window."""

    __slots__ = ("obj", "hist", "total", "breaches", "buckets", "last_t")

    def __init__(self, obj: SloObjective):
        self.obj = obj
        self.hist = Histogram(f"slo.{obj.function}.latency_s")
        self.total = 0
        self.breaches = 0
        # (bucket_index, total, breaches) — appended in time order
        self.buckets: Deque[List[float]] = deque()
        self.last_t = 0.0

    def observe(self, t: float, latency_s: float, width: float,
                keep: float) -> None:
        self.last_t = max(self.last_t, t)
        self.hist.observe(latency_s)
        bad = 1 if latency_s > self.obj.threshold_s else 0
        self.total += 1
        self.breaches += bad
        idx = int(t // width)
        if self.buckets and self.buckets[-1][0] == idx:
            b = self.buckets[-1]
            b[1] += 1
            b[2] += bad
        else:
            self.buckets.append([idx, 1, bad])
        horizon = int((self.last_t - keep) // width)
        while self.buckets and self.buckets[0][0] < horizon:
            self.buckets.popleft()

    def window_counts(self, window: float, now: float,
                      width: float) -> Tuple[int, int]:
        lo = int((now - window) // width)
        total = bad = 0
        for idx, n, b in self.buckets:
            if idx >= lo:
                total += n
                bad += b
        return total, bad


class SloEngine:
    """Objectives + sliding windows + multi-window burn alerts.

    ``objectives`` is a mapping ``{function: threshold_s}`` (or
    ``{function: SloObjective}`` / an iterable of objectives).  Windows are
    in the caller's time unit (simulated seconds here); ``alert_burn`` is
    the burn-rate threshold both windows must exceed to alert."""

    def __init__(self, objectives: Union[Mapping[str, ObjectiveLike],
                                         Iterable[SloObjective]], *,
                 fast_window: float = 30.0, slow_window: float = 300.0,
                 alert_burn: float = 1.0, buckets_per_window: int = 10):
        if fast_window <= 0 or slow_window < fast_window:
            raise ValueError("need 0 < fast_window <= slow_window")
        self.fast_window = float(fast_window)
        self.slow_window = float(slow_window)
        self.alert_burn = float(alert_burn)
        self._width = self.fast_window / float(buckets_per_window)
        self._slos: Dict[str, _FunctionSlo] = {
            fn: _FunctionSlo(o) for fn, o in _normalize(objectives).items()}
        self._now = 0.0

    def __contains__(self, function: str) -> bool:
        return function in self._slos

    def objectives(self) -> Dict[str, SloObjective]:
        return {fn: s.obj for fn, s in self._slos.items()}

    # ---- write path -------------------------------------------------------- #

    def observe(self, function: str, t: float, latency_s: float) -> None:
        """Record one completed invocation at virtual time ``t``.  Functions
        without an objective are ignored (free on the caller's hot path)."""
        s = self._slos.get(function)
        if s is None:
            return
        self._now = max(self._now, t)
        s.observe(t, latency_s, self._width, self.slow_window)

    # ---- read surfaces ----------------------------------------------------- #

    def burn_rates(self, function: str,
                   now: Optional[float] = None) -> Tuple[float, float]:
        """(fast, slow) burn rates at ``now`` (default: last observed time).
        Burn = breach fraction over the window / the error budget; 0.0 with
        no traffic in the window."""
        s = self._slos[function]
        t = self._now if now is None else now

        def burn(window: float) -> float:
            total, bad = s.window_counts(window, t, self._width)
            if total == 0:
                return 0.0
            return (bad / total) / s.obj.error_budget

        return burn(self.fast_window), burn(self.slow_window)

    def alerting(self, function: str, now: Optional[float] = None) -> bool:
        fast, slow = self.burn_rates(function, now)
        return fast >= self.alert_burn and slow >= self.alert_burn

    def alerts(self, now: Optional[float] = None) -> List[str]:
        """Functions currently violating the multi-window burn condition."""
        return [fn for fn in self._slos if self.alerting(fn, now)]

    def budget_remaining(self, function: str) -> float:
        """Cumulative error-budget fraction left (negative = blown) — the
        signal admission control sheds on.  Raises ``KeyError`` for a
        function with no registered objective: a shed decision against a
        budget that does not exist would be silent garbage (guard with
        ``function in engine``)."""
        s = self._slos.get(function)
        if s is None:
            raise KeyError(
                f"no SLO objective registered for function {function!r}; "
                f"have {sorted(self._slos)}")
        if s.total == 0:
            return 1.0
        return 1.0 - (s.breaches / s.total) / s.obj.error_budget

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """Per-function objective + SLI + budget + burn state — the shape
        ``Platform.stats()["slo"]`` and the obs collector export.  Booleans
        are 0/1 ints so the Prometheus render keeps every row."""
        out: Dict[str, Dict[str, float]] = {}
        for fn, s in self._slos.items():
            fast, slow = self.burn_rates(fn)
            q = s.obj.target_quantile
            measured = s.hist.quantile(q)
            out[fn] = {
                "threshold_s": s.obj.threshold_s,
                "compliance": s.obj.compliance,
                "quantile": q,
                "observed": s.total,
                "breaches": s.breaches,
                "good_fraction": round(
                    1.0 - (s.breaches / s.total), 6) if s.total else 1.0,
                "measured_quantile_s": round(measured, 9),
                "budget_remaining": round(self.budget_remaining(fn), 6),
                "burn_fast": round(fast, 6),
                "burn_slow": round(slow, 6),
                "alerting": int(fast >= self.alert_burn
                                and slow >= self.alert_burn),
            }
        return out

    def register_into(self, registry, prefix: str = "slo") -> None:
        """Register the engine as a snapshot-time collector: per-function
        keys appear as ``slo.<function>.<field>`` in ``snapshot()`` and the
        Prometheus render."""
        registry.register_collector(prefix, self.snapshot)
