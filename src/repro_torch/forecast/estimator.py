"""Arrival-rate estimation — the prediction half of the forecast subsystem.

Three estimators feed the planner (and the ``predictive`` keep-alive policy):

* :class:`DecayingRate` — a per-function exponentially-decayed event rate
  (each arrival adds ``1/tau``, the whole estimate decays ``e^{-dt/tau}``):
  the EWMA workhorse for poisson/bursty regimes.  Because decay is a pure
  function of elapsed time, the instant the estimate will cross any
  threshold is computable in closed form (``keep_until``) — the janitor can
  schedule a *firm* re-examination time instead of polling;
* :class:`SeasonalProfile` — a Holt-Winters-style multiplicative seasonal
  profile over a known period (the diurnal day/night cycle): per-bin arrival
  counts update a smoothed level and per-bin seasonal factors, and the
  factor for a *future* bin anticipates the morning ramp before the EWMA
  sees it;
* :class:`SuccessorStats` — a DAG-successor predictor that learns
  ``parent -> (child, count, lag)`` edges from observed chained arrivals
  (a running ``divide`` will spawn two ``impera``s ~0.3 s from now).  Edges
  can be *seeded* from the aAPP script's affinity terms: a tag whose policy
  is affine to another tag declares the dependency before any arrival is
  observed.

:class:`ArrivalForecast` composes the three behind the single interface the
rest of the system consumes (``observe`` / ``expected_arrivals`` /
``successor_demand`` / ``keep_until``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Tuple

# Seasonal factors are clipped to this envelope; ``keep_until`` uses the
# upper bound as its conservative worst case so the computed expiry time is
# never earlier than the actual threshold crossing.
SEASON_MIN, SEASON_MAX = 0.25, 4.0


class DecayingRate:
    """Exponentially-decayed arrival rate per key, in events/second.

    ``observe`` adds ``1/tau`` to the key's rate; between observations the
    rate decays ``e^{-dt/tau}``.  A steady Poisson stream of rate λ
    converges to an estimate of λ.
    """

    def __init__(self, tau: float = 20.0):
        if tau <= 0:
            raise ValueError("tau must be positive")
        self.tau = float(tau)
        self._state: Dict[str, Tuple[float, float]] = {}  # key -> (rate, t)

    def observe(self, key: str, t: float, weight: float = 1.0) -> None:
        self._state[key] = (self.rate(key, t) + weight / self.tau, t)

    def rate(self, key: str, now: float) -> float:
        got = self._state.get(key)
        if got is None:
            return 0.0
        r, last = got
        if now <= last:
            return r
        return r * math.exp(-(now - last) / self.tau)

    def keys(self) -> Tuple[str, ...]:
        return tuple(self._state)


class MeanEstimate:
    """Plain EWMA of a scalar (service times, successor counts/lags)."""

    def __init__(self, alpha: float = 0.3, initial: Optional[float] = None,
                 prior_weight: float = 0.0):
        self.alpha = float(alpha)
        self.value = initial
        # prior observations "already seen": real samples outweigh the seed
        self._n = prior_weight

    def observe(self, x: float) -> None:
        if self.value is None:
            self.value = float(x)
        else:
            # early samples get larger steps so a weak prior converges fast
            a = max(self.alpha, 1.0 / (self._n + 1.0))
            self.value += a * (float(x) - self.value)
        self._n += 1.0

    def get(self, default: float = 0.0) -> float:
        return self.value if self.value is not None else default


class SeasonalProfile:
    """Holt-Winters-style multiplicative seasonal profile over one period.

    Time is discretised into ``nbins`` bins of the period; each completed bin
    updates a smoothed level (``alpha``) and its seasonal factor (``gamma``)
    as ``count / level``.  ``factor(t)`` returns the (clipped) factor of the
    bin containing ``t`` — pass a *future* ``t`` to anticipate the cycle.
    Bins that elapse without any arrival still update (count 0), so a trace
    that goes quiet decays honestly.
    """

    def __init__(self, period: float, *, nbins: int = 16,
                 alpha: float = 0.35, gamma: float = 0.35):
        if period <= 0:
            raise ValueError("period must be positive")
        self.period = float(period)
        self.nbins = int(nbins)
        self.alpha = float(alpha)
        self.gamma = float(gamma)
        self.bin_s = self.period / self.nbins
        self.level: Optional[float] = None
        self.season: List[float] = [1.0] * self.nbins
        self._cur_bin: Optional[int] = None  # absolute bin index
        self._cur_count = 0.0

    def _abs_bin(self, t: float) -> int:
        return int(t // self.bin_s)

    def _roll_to(self, b: int) -> None:
        """Close every bin strictly before ``b``."""
        if self._cur_bin is None:
            self._cur_bin = b
            return
        while self._cur_bin < b:
            count = self._cur_count
            idx = self._cur_bin % self.nbins
            if self.level is None:
                self.level = count
            else:
                self.level += self.alpha * (count - self.level)
            if self.level and self.level > 1e-12:
                f = count / self.level
                self.season[idx] += self.gamma * (f - self.season[idx])
            self._cur_bin += 1
            self._cur_count = 0.0

    def observe(self, t: float, weight: float = 1.0) -> None:
        self._roll_to(self._abs_bin(t))
        self._cur_count += weight

    def factor(self, t: float) -> float:
        if self.level is None:
            return 1.0
        f = self.season[self._abs_bin(t) % self.nbins]
        return min(SEASON_MAX, max(SEASON_MIN, f))


@dataclasses.dataclass(frozen=True)
class Successor:
    """One learned DAG edge: ``parent`` spawns ``count`` x ``child`` after
    ``lag`` seconds (both EWMA means)."""

    child: str
    count: float
    lag: float


class SuccessorStats:
    """Learns ``parent -> (child, count, lag)`` from observed chained spawns.

    ``observe_edge(parent, child, count, lag)`` is fired by the workload
    driver at the moment a finishing parent submits its children.  Affinity
    seeding (:meth:`seed`) installs a weak prior edge (count 1, lag 0) that
    real observations quickly overwrite.
    """

    _PRIOR_WEIGHT = 1.0

    def __init__(self):
        self._edges: Dict[str, Dict[str, Tuple[MeanEstimate, MeanEstimate]]] = {}

    def seed(self, parent: str, child: str, *, count: float = 1.0,
             lag: float = 0.0) -> None:
        kids = self._edges.setdefault(parent, {})
        if child not in kids:
            kids[child] = (
                MeanEstimate(initial=count, prior_weight=self._PRIOR_WEIGHT),
                MeanEstimate(initial=lag, prior_weight=self._PRIOR_WEIGHT),
            )

    def observe_edge(self, parent: str, child: str, count: float,
                     lag: float) -> None:
        kids = self._edges.setdefault(parent, {})
        if child not in kids:
            kids[child] = (MeanEstimate(), MeanEstimate())
        cnt, lg = kids[child]
        cnt.observe(count)
        lg.observe(lag)

    def successors(self, parent: str) -> List[Successor]:
        return [Successor(child, cnt.get(), lg.get())
                for child, (cnt, lg) in self._edges.get(parent, {}).items()]

    def parents(self) -> Tuple[str, ...]:
        return tuple(self._edges)


class ArrivalForecast:
    """The estimator facade: per-function EWMA rates, an optional shared
    seasonal profile, learned service times and DAG-successor edges.

    ``expected_arrivals(f, now, horizon)`` — predicted number of direct
    arrivals of ``f`` in ``[now, now+horizon)``; ``successor_demand`` adds
    the children that currently-running parents will spawn.  ``keep_until``
    gives the janitor a firm time at which the prediction can first drop
    below a threshold (infinity never happens: without new observations the
    EWMA decays monotonically).
    """

    def __init__(self, *, tau: float = 20.0,
                 seasonal_period: Optional[float] = None,
                 seasonal_bins: int = 16):
        self.rates = DecayingRate(tau=tau)
        self.seasonal = (SeasonalProfile(seasonal_period, nbins=seasonal_bins)
                         if seasonal_period else None)
        self.dag = SuccessorStats()
        self._service: Dict[str, MeanEstimate] = {}
        self.observations = 0

    # ---- observation feed ------------------------------------------------- #

    def observe(self, function: str, t: float) -> None:
        """One arrival of ``function`` at time ``t``."""
        self.rates.observe(function, t)
        if self.seasonal is not None:
            self.seasonal.observe(t)
        self.observations += 1

    def observe_edge(self, parent: str, child: str, count: float,
                     lag: float) -> None:
        self.dag.observe_edge(parent, child, count, lag)

    def observe_service(self, function: str, seconds: float) -> None:
        self._service.setdefault(function, MeanEstimate()).observe(seconds)

    def seed_affinity(self, script, registry) -> None:
        """Prior DAG edges from declared aAPP affinity: a function whose tag's
        policy is *affine to* tag T is expected to follow functions tagged T
        (the ``impera``-affine-to-``divide`` pattern).  Resolved against the
        registry so edges connect concrete function names."""
        from repro_torch.core.scheduler import candidate_blocks  # cycle-free import

        by_tag: Dict[str, List[str]] = {}
        names = registry.names()
        for fname in names:
            by_tag.setdefault(registry[fname].tag, []).append(fname)
        for child in names:
            ctag = registry[child].tag
            for block in candidate_blocks(ctag, script):
                for ptag in block.affinity.affine:
                    for parent in by_tag.get(ptag, ()):
                        if parent != child:
                            self.dag.seed(parent, child)

    # ---- predictions ------------------------------------------------------ #

    def rate(self, function: str, now: float) -> float:
        return self.rates.rate(function, now)

    def service_time(self, function: str, default: float = 0.5) -> float:
        got = self._service.get(function)
        return got.get(default) if got is not None else default

    def expected_arrivals(self, function: str, now: float,
                          horizon: float) -> float:
        lam = self.rates.rate(function, now)
        if self.seasonal is not None:
            lam *= self.seasonal.factor(now + horizon / 2.0)
        return lam * horizon

    def successor_demand(self, inflight: Mapping[str, int], horizon: float
                         ) -> Dict[str, float]:
        """Children that currently-running parents will spawn within
        ``horizon`` (edges with a learned lag beyond the horizon are not
        actionable this epoch)."""
        out: Dict[str, float] = {}
        for parent, n in inflight.items():
            if n <= 0:
                continue
            for s in self.dag.successors(parent):
                if s.lag <= horizon:
                    out[s.child] = out.get(s.child, 0.0) + n * s.count
        return out

    # keep_until returns a time strictly PAST the threshold crossing: an event
    # fired exactly at the computed instant must observe the prediction as
    # already below threshold, or the janitor would reschedule a sweep at the
    # same simulated time forever.
    _CROSS_PAD = 1e-6

    def keep_until(self, function: str, now: float, horizon: float,
                   threshold: float) -> float:
        """First time ``expected_arrivals`` can have dropped below
        ``threshold`` absent further observations (conservative: assumes the
        max seasonal factor).  Returns ``now`` when already below."""
        lam = self.rates.rate(function, now)
        smax = SEASON_MAX if self.seasonal is not None else 1.0
        peak = lam * smax * horizon
        if peak < threshold or threshold <= 0:
            return now
        return (now + self.rates.tau * math.log(peak / threshold)
                + self._CROSS_PAD)

    # ---- observability ---------------------------------------------------- #

    def state(self, now: float, horizon: float = 1.0) -> Dict[str, Dict]:
        """Per-function forecast snapshot (engine / benchmark stats)."""
        out: Dict[str, Dict] = {}
        for f in self.rates.keys():
            out[f] = {
                "rate_per_s": round(self.rates.rate(f, now), 6),
                "expected_next_s": round(
                    self.expected_arrivals(f, now, horizon), 6),
                "service_s": round(self.service_time(f), 6),
                "successors": [dataclasses.asdict(s)
                               for s in self.dag.successors(f)],
            }
        return out
