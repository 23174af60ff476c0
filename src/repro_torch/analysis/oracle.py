"""Service-time oracles for the cost calculus.

The calculus needs one number per function — its worst-case service seconds
on one worker — and does not care where it comes from.  Two sources cover
the repo's workloads:

* :class:`TableOracle` — a plain ``{function: seconds}`` mapping (the
  simulator's ``COMPUTE_S`` tables, operator-measured service times);
* :class:`RooflineOracle` — roofline-derived numbers for *model* functions;
  not ported yet, so it raises (see its docstring).

Both return ``None`` for unknown functions; the calculus then falls back to
:attr:`repro.analysis.calculus.AnalysisConfig.default_service_s` (no
diagnostic — a missing measurement must not fail an old script's compile).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional


class ServiceOracle:
    """One function's worst-case service seconds, or ``None`` if unknown."""

    def service_s(self, function: str) -> Optional[float]:
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<{type(self).__name__}>"


class TableOracle(ServiceOracle):
    """Measured/declared service times from a ``{function: seconds}`` map."""

    def __init__(self, table: Mapping[str, float]):
        self.table: Dict[str, float] = {k: float(v) for k, v in table.items()}

    def service_s(self, function: str) -> Optional[float]:
        return self.table.get(function)


class RooflineOracle(ServiceOracle):
    """Roofline-derived service times for model functions.

    The reference derives them from partitioned XLA HLO
    (``repro.roofline.flops``); the port has no roofline model yet — it
    comes with the mesh and roofline tooling (``ROADMAP.md``).  Until then
    constructing one raises.
    """

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "RooflineOracle needs the roofline model, which the port has not "
            "ported yet (ROADMAP.md: the mesh and roofline tooling); pass a "
            "TableOracle or a {function: seconds} mapping instead")


def as_oracle(source) -> Optional[ServiceOracle]:
    """Normalise ``service_times=``: a mapping becomes a
    :class:`TableOracle`, an oracle passes through, ``None`` stays ``None``."""
    if source is None:
        return None
    if isinstance(source, ServiceOracle):
        return source
    if isinstance(source, Mapping):
        return TableOracle(source)
    raise TypeError(
        f"service_times must be a mapping or a ServiceOracle, "
        f"got {type(source).__name__}")
