"""Service-time oracles for the cost calculus.

The calculus needs one number per function — its worst-case service seconds
on one worker — and does not care where it comes from.  Two sources cover
the repo's workloads:

* :class:`TableOracle` — a plain ``{function: seconds}`` mapping (the
  simulator's ``COMPUTE_S`` tables, operator-measured service times);
* :class:`RooflineOracle` — derives the number for *model* functions from
  their partitioned HLO via the loop-aware cost model in
  :mod:`repro_torch.roofline.flops`, or from a PyTorch program counted op
  by op (:class:`repro_torch.roofline.flops.OpCounter`): service is the
  roofline bound ``max(flops / peak_flops, bytes / peak_bytes)``.

Both return ``None`` for unknown functions; the calculus then falls back to
:attr:`repro_torch.analysis.calculus.AnalysisConfig.default_service_s` (no
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

    Feed it HLO text per function (:meth:`add_hlo`), a PyTorch call to
    count (:meth:`add_module`) or precomputed ``(flops, bytes)`` pairs
    (:meth:`add_counts`); ``service_s`` returns the roofline bound against
    the configured peaks.  An optional fallback
    table covers the non-model functions of a mixed registry.
    """

    def __init__(self, *, peak_flops_s: float, peak_bytes_s: float,
                 table: Optional[Mapping[str, float]] = None):
        if peak_flops_s <= 0 or peak_bytes_s <= 0:
            raise ValueError("roofline peaks must be positive")
        self.peak_flops_s = float(peak_flops_s)
        self.peak_bytes_s = float(peak_bytes_s)
        self._derived: Dict[str, float] = {}
        self._fallback = TableOracle(table) if table else None

    def add_hlo(self, function: str, hlo_text: str) -> float:
        from repro_torch.roofline.flops import analyze, roofline_seconds

        counts = analyze(hlo_text)
        s = roofline_seconds(counts["flops"], counts["bytes"],
                             peak_flops_s=self.peak_flops_s,
                             peak_bytes_s=self.peak_bytes_s)
        self._derived[function] = s
        return s

    def add_counts(self, function: str, flops: float, bytes_: float) -> float:
        from repro_torch.roofline.flops import roofline_seconds

        s = roofline_seconds(flops, bytes_,
                             peak_flops_s=self.peak_flops_s,
                             peak_bytes_s=self.peak_bytes_s)
        self._derived[function] = s
        return s

    def add_module(self, function: str, fn, *args) -> float:
        """Count ``fn(*args)`` op by op (under ``FakeTensorMode`` when the
        arguments are fake tensors, so nothing runs) and set the
        function's bound from the counts."""
        from repro_torch.roofline.flops import count

        _, counts = count(fn, *args)
        return self.add_counts(function, counts["flops"], counts["bytes"])

    def service_s(self, function: str) -> Optional[float]:
        got = self._derived.get(function)
        if got is not None:
            return got
        if self._fallback is not None:
            return self._fallback.service_s(function)
        return None


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
