"""Trace generators — arrival processes the serverless literature measures.

Each generator yields a time-sorted list of :class:`Arrival` events over
``[0, duration)``:

* **poisson** — memoryless constant-rate arrivals (the classic open-loop
  baseline);
* **bursty**  — a two-state ON/OFF (interrupted-Poisson) process: bursts of
  high-rate traffic separated by silent gaps, the regime where keep-alive TTLs
  are won or lost;
* **diurnal** — sinusoidally-modulated rate (day/night cycle), sampled by
  thinning a dominating Poisson process;
* **chained** — divide-et-impera DAG roots: each arrival is a parent function
  whose *children* are declared on the arrival (spawned by the driver when the
  parent finishes computing, as OpenWhisk sequences/compositions do);
* **overload** — multi-tenant Poisson streams (one per tenant) whose summed
  rate is meant to exceed capacity — the admission-control/fair-queueing
  regime of ``benchmarks/overload.py``.

All randomness flows through an explicit ``random.Random`` so traces are
reproducible across the simulator, the benchmarks and the tests.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Arrival:
    t: float
    function: str
    session: Optional[str] = None
    # (child function, count) pairs spawned when this invocation's compute
    # finishes — the divide -> 2 x impera DAG edge.
    children: Tuple[Tuple[str, int], ...] = ()
    # origin zone of the request (multi-region traces); None = zone-agnostic.
    # The workload driver forwards it to the scheduler as the sharded
    # router's ``local_first`` locality hint.
    zone: Optional[str] = None
    # owning tenant (admission control / weighted-fair queueing); None maps
    # to the default tenant, so pre-existing traces are unchanged objects
    # and bit-identity of every existing run is preserved.
    tenant: Optional[str] = None


def _pick(rng: random.Random, functions: Sequence[Tuple[str, float]]) -> str:
    """Weighted function choice: [(name, weight), ...]."""
    total = sum(w for _, w in functions)
    x = rng.random() * total
    for name, w in functions:
        x -= w
        if x <= 0:
            return name
    return functions[-1][0]


def poisson_trace(
    rate: float,
    duration: float,
    functions: Sequence[Tuple[str, float]],
    rng: random.Random,
) -> List[Arrival]:
    out: List[Arrival] = []
    t = rng.expovariate(rate)
    while t < duration:
        out.append(Arrival(t=t, function=_pick(rng, functions)))
        t += rng.expovariate(rate)
    return out


def bursty_trace(
    on_rate: float,
    duration: float,
    functions: Sequence[Tuple[str, float]],
    rng: random.Random,
    *,
    on_mean: float = 5.0,
    off_mean: float = 20.0,
) -> List[Arrival]:
    """ON/OFF: exponentially-distributed ON windows at ``on_rate``, silent OFF
    windows of mean ``off_mean`` — the gap is what defeats fixed TTLs."""
    out: List[Arrival] = []
    t = 0.0
    while t < duration:
        on_end = t + rng.expovariate(1.0 / on_mean)
        a = t + rng.expovariate(on_rate)
        while a < min(on_end, duration):
            out.append(Arrival(t=a, function=_pick(rng, functions)))
            a += rng.expovariate(on_rate)
        t = on_end + rng.expovariate(1.0 / off_mean)
    return out


def diurnal_trace(
    base_rate: float,
    peak_rate: float,
    duration: float,
    functions: Sequence[Tuple[str, float]],
    rng: random.Random,
    *,
    period: float = 60.0,
) -> List[Arrival]:
    """Rate(t) = base + (peak-base) * (1+sin(2πt/period))/2, by thinning."""
    if peak_rate < base_rate:
        raise ValueError("peak_rate must be >= base_rate")
    out: List[Arrival] = []
    lam_max = peak_rate
    t = rng.expovariate(lam_max)
    while t < duration:
        lam = base_rate + (peak_rate - base_rate) * (
            1.0 + math.sin(2.0 * math.pi * t / period)) / 2.0
        if rng.random() < lam / lam_max:
            out.append(Arrival(t=t, function=_pick(rng, functions)))
        t += rng.expovariate(lam_max)
    return out


def multiregion_trace(
    zone_weights: Sequence[Tuple[str, float]],
    base_rate: float,
    peak_rate: float,
    duration: float,
    functions: Sequence[Tuple[str, float]],
    rng: random.Random,
    *,
    period: float = 60.0,
) -> List[Arrival]:
    """Skewed per-zone diurnal arrivals (the multi-region regime of
    Przybylski et al.'s data-driven scheduling setting).

    Each zone runs its own sinusoidal day/night cycle, *phase-shifted* by
    its position around the globe (zone ``i`` of ``Z`` is offset by
    ``i/Z`` of a period — when one region peaks another idles) and scaled
    by its traffic weight.  Every arrival is stamped with its origin zone,
    which the sharded control plane's ``local_first`` router consumes.
    Merged time-sorted with a deterministic (t, zone) tiebreak."""
    if peak_rate < base_rate:
        raise ValueError("peak_rate must be >= base_rate")
    total_w = sum(w for _, w in zone_weights)
    if total_w <= 0:
        raise ValueError("zone weights must sum positive")
    out: List[Arrival] = []
    Z = len(zone_weights)
    for i, (zone, weight) in enumerate(zone_weights):
        scale = weight * Z / total_w  # weights redistribute, not inflate
        lam_base = base_rate * scale
        lam_peak = peak_rate * scale
        lam_max = lam_peak
        if lam_max <= 0:
            continue
        phase = (i / Z) * period
        t = rng.expovariate(lam_max)
        while t < duration:
            lam = lam_base + (lam_peak - lam_base) * (
                1.0 + math.sin(2.0 * math.pi * (t + phase) / period)) / 2.0
            if rng.random() < lam / lam_max:
                out.append(Arrival(t=t, function=_pick(rng, functions),
                                   zone=zone))
            t += rng.expovariate(lam_max)
    out.sort(key=lambda a: (a.t, a.zone or ""))
    return out


def overload_trace(
    tenant_rates: Sequence[Tuple[str, float]],
    duration: float,
    functions: Sequence[Tuple[str, float]],
    rng: random.Random,
) -> List[Arrival]:
    """Multi-tenant open-loop overload: each tenant is an independent
    constant-rate Poisson stream (``[(tenant, rate), ...]``) over the
    shared function mix — drive the sum past cluster capacity and the
    admission/fairness layer decides who gets shed.  Merged time-sorted
    with a deterministic ``(t, tenant)`` tiebreak.  A fresh generator
    (new rng stream), so no existing trace's draws are disturbed."""
    out: List[Arrival] = []
    for tenant, rate in tenant_rates:
        if rate <= 0:
            continue
        t = rng.expovariate(rate)
        while t < duration:
            out.append(Arrival(t=t, function=_pick(rng, functions),
                               tenant=tenant))
            t += rng.expovariate(rate)
    out.sort(key=lambda a: (a.t, a.tenant or ""))
    return out


def chained_trace(
    rate: float,
    duration: float,
    rng: random.Random,
    *,
    parent: str = "divide",
    children: Tuple[Tuple[str, int], ...] = (("impera", 2),),
) -> List[Arrival]:
    """Poisson arrivals of DAG roots; children are spawned by the driver."""
    out: List[Arrival] = []
    t = rng.expovariate(rate)
    while t < duration:
        out.append(Arrival(t=t, function=parent, children=children))
        t += rng.expovariate(rate)
    return out
