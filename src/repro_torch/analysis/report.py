"""The analysis product: one report object, one byte-stable rendering.

:func:`analyze` is the subsystem's single entry point — the compile driver
calls it with the pipeline's already-resolved chains, and
:meth:`repro.platform.Platform.verify` calls it against the live cluster
shape.  It never raises on findings: errors and warnings alike ride on
``report.diagnostics`` (sorted by severity / tag / block index, so
``format()`` output is byte-stable across runs); the *compile* driver is
what turns error-severity findings into a :class:`CompileError`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.core.ast import AAppScript
from repro_torch.core.compile import (
    Diagnostic,
    ResolvedPolicy,
    SEVERITY_ERROR,
    resolve,
    sort_diagnostics,
)
from repro_torch.core.state import Registry

from .calculus import AnalysisConfig, TagCost, cost_pass
from .oracle import as_oracle
from .reach import as_worker_shapes, reachability_pass


@dataclasses.dataclass(frozen=True)
class AnalysisReport:
    """Everything the v4 static passes derived for one script."""

    tags: Tuple[TagCost, ...]
    diagnostics: Tuple[Diagnostic, ...]  # sorted; both severities
    workers_analysed: int  # 0 = no cluster shape given (cost pass only)
    budget_mb: Optional[float]

    @property
    def errors(self) -> Tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics
                     if d.severity == SEVERITY_ERROR)

    @property
    def ok(self) -> bool:
        return not self.diagnostics

    def format(self) -> str:
        """Byte-stable human rendering (pinned by a golden test)."""
        shape = (f"{self.workers_analysed} workers"
                 if self.workers_analysed else "no cluster shape")
        budget = (f", keep-alive budget {self.budget_mb:g} MB"
                  if self.budget_mb is not None else "")
        lines = [f"== static analysis ({shape}{budget}) =="]
        header = (f"{'tag':10s} {'chain':16s} {'mem_mb':>7s} {'service':>8s} "
                  f"{'cold_s':>7s} {'warm_s':>7s} {'chain_cold':>10s} "
                  f"{'chain_warm':>10s} {'budget_s':>8s} {'usd/invoke':>11s}")
        lines.append(header)
        for t in self.tags:
            mem = f"{t.footprint_mb:g}" if t.footprint_mb is not None else "-"
            budget_s = f"{t.budget_s:g}" if t.budget_s is not None else "-"
            usd = (f"{t.usd_per_invoke:.6f}"
                   if t.usd_per_invoke is not None else "-")
            lines.append(
                f"{t.tag:10s} {'->'.join(t.chain):16s} {mem:>7s} "
                f"{t.service_s:8.3f} {t.cold_s:7.3f} {t.warm_s:7.3f} "
                f"{t.chain_cold_s:10.3f} {t.chain_warm_s:10.3f} "
                f"{budget_s:>8s} {usd:>11s}")
        if self.diagnostics:
            lines.append(f"diagnostics ({len(self.diagnostics)}):")
            for d in self.diagnostics:
                lines.append(f"  {d}")
        else:
            lines.append("diagnostics: none")
        return "\n".join(lines) + "\n"


def analyze(
    script: AAppScript,
    reg: Registry,
    *,
    resolved: Optional[Dict[str, ResolvedPolicy]] = None,
    workers=None,
    budget_mb: Optional[float] = None,
    service_times=None,
    config: Optional[AnalysisConfig] = None,
) -> AnalysisReport:
    """Run the cost calculus and (with a cluster shape) the reachability
    pass; returns the report, never raises on findings.

    ``workers`` is any shape :func:`repro.analysis.reach.as_worker_shapes`
    accepts; ``budget_mb`` is the warm pool's per-worker keep-alive budget
    (colocation is checked against ``min(worker memory, budget)``);
    ``service_times`` is a ``{function: seconds}`` map or a
    :class:`~repro.analysis.oracle.ServiceOracle`."""
    config = config if config is not None else AnalysisConfig()
    resolved = resolved if resolved is not None else resolve(script)
    oracle = as_oracle(service_times)

    tags, diags = cost_pass(script, resolved, reg, config, oracle)
    shapes = as_worker_shapes(workers) if workers is not None else ()
    if shapes:
        diags = diags + reachability_pass(
            script, resolved, reg, shapes, config, budget_mb)
    return AnalysisReport(
        tags=tags,
        diagnostics=sort_diagnostics(diags),
        workers_analysed=len(shapes),
        budget_mb=budget_mb if shapes else None,
    )
