"""Named workload scenarios — the four arrival regimes every benchmark runs.

``build_trace(name, ...)`` produces a reproducible trace for one of:

* ``poisson``  — steady open-loop traffic over a small function mix;
* ``bursty``   — ON/OFF bursts with keep-alive-defeating silent gaps;
* ``diurnal``  — sinusoidal day/night rate modulation;
* ``chained``  — divide-et-impera DAG roots (children spawn on parent finish).

``register_functions`` installs the scenario function mix into a
:class:`repro_torch.core.state.Registry` (memory + tag), and ``COMPUTE_S`` gives
each function's single-vCPU compute demand for the simulator.
"""
from __future__ import annotations

import random
from typing import Dict, List, Sequence, Tuple

from repro_torch.core.state import Registry

from .traces import (
    Arrival,
    bursty_trace,
    chained_trace,
    diurnal_trace,
    multiregion_trace,
    poisson_trace,
)

# name -> (memory_mb, tag, compute_s, arrival_weight)
FUNCTION_MIX: Dict[str, Tuple[float, str, float, float]] = {
    "api": (128.0, "api", 0.25, 6.0),
    "thumb": (256.0, "img", 1.00, 3.0),
    "etl": (192.0, "etl", 2.50, 1.0),
    "divide": (256.0, "d", 0.30, 1.0),
    "impera": (192.0, "i", 1.50, 0.0),  # spawned by divide, never a root
}

COMPUTE_S: Dict[str, float] = {n: c for n, (_m, _t, c, _w) in FUNCTION_MIX.items()}

SCENARIOS: Tuple[str, ...] = ("poisson", "bursty", "diurnal", "chained")

# the multi-region scenario is additive (zone-stamped arrivals for the
# sharded control plane); the 4-scenario cold-start baseline stays as is
MULTIREGION = "multiregion"
#: default zone traffic skew: a dominant region, a mid one, a small one
MULTIREGION_ZONES: Tuple[Tuple[str, float], ...] = (
    ("eu", 3.0), ("us", 2.0), ("ap", 1.0))


def register_functions(reg: Registry, names: Sequence[str] = None) -> None:
    for n in (names if names is not None else FUNCTION_MIX):
        mem, tag, _c, _w = FUNCTION_MIX[n]
        if n not in reg:
            reg.register(n, memory=mem, tag=tag)


def _mix(names: Sequence[str]) -> List[Tuple[str, float]]:
    return [(n, FUNCTION_MIX[n][3]) for n in names if FUNCTION_MIX[n][3] > 0]


def build_trace(name: str, *, duration: float = 120.0, rate: float = 2.0,
                seed: int = 0,
                zones: Sequence[Tuple[str, float]] = MULTIREGION_ZONES,
                ) -> List[Arrival]:
    rng = random.Random(seed)
    simple = _mix(["api", "thumb", "etl"])
    if name == "poisson":
        return poisson_trace(rate, duration, simple, rng)
    if name == "bursty":
        return bursty_trace(4.0 * rate, duration, simple, rng,
                            on_mean=6.0, off_mean=18.0)
    if name == "diurnal":
        return diurnal_trace(0.2 * rate, 3.0 * rate, duration, simple, rng,
                             period=duration / 2.0)
    if name == "chained":
        return chained_trace(rate, duration, rng,
                             parent="divide", children=(("impera", 2),))
    if name == MULTIREGION:
        return multiregion_trace(tuple(zones), 0.2 * rate, 3.0 * rate,
                                 duration, simple, rng,
                                 period=duration / 2.0)
    raise ValueError(
        f"unknown scenario {name!r}; have {SCENARIOS + (MULTIREGION,)}")
