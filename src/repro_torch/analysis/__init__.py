"""Compile-time static analysis for aAPP scripts (the IR v4 subsystem).

Two passes hang off the :func:`repro.core.compile.compile_script` pipeline,
grounded in the cost/reachability literature the roadmap names (*Serverless
Scheduling Policies based on Cost Analysis*, arXiv 2310.20391; *On the
Complexity of Reachability Properties in Serverless Function Scheduling*,
arXiv 2407.14159):

* the **cost calculus** (:mod:`repro.analysis.calculus`) — derives every
  tag's worst-case cold/warm-path latency and $-cost from the registry
  footprints, a pluggable service-time oracle (:mod:`repro.analysis.oracle`;
  the roofline model in :mod:`repro_torch.roofline.flops` is the oracle for model
  functions) and the warm pool's lifecycle constants, and checks the
  per-block ``cost:`` budgets (``over-budget`` diagnostics);
* the **reachability pass** (:mod:`repro.analysis.reach`) — given a concrete
  cluster shape, proves whether every tag's chained DAG can be placed under
  the combined affinity + anti-affinity + zone + memory constraints
  (``unplaceable-chain`` errors) and whether its affinity group can stay
  *warm-co-resident* under the keep-alive budget (``budget-bound-colocation``
  warnings — the chained scenario's 512 MB cold-start floor, caught before a
  single container boots).

:func:`analyze` composes both into an :class:`AnalysisReport` whose
``format()`` is byte-stable (diagnostics sorted by severity/tag/block);
``compile_script(workers=...)`` attaches the report to the IR and
:meth:`repro.platform.Platform.verify` runs it against the live cluster.
"""
from .calculus import (
    AnalysisConfig,
    LifecycleCosts,
    TagCost,
    affinity_chain,
    cost_pass,
)
from .diagnostics import (
    CODE_BUDGET_COLOCATION,
    CODE_IR_VERSION,
    CODE_OVER_BUDGET,
    CODE_UNPLACEABLE,
)
from .oracle import RooflineOracle, ServiceOracle, TableOracle
from .reach import WorkerShape, as_worker_shapes, reachability_pass
from .report import AnalysisReport, analyze

__all__ = [
    "AnalysisConfig",
    "AnalysisReport",
    "LifecycleCosts",
    "RooflineOracle",
    "ServiceOracle",
    "TableOracle",
    "TagCost",
    "WorkerShape",
    "affinity_chain",
    "analyze",
    "as_worker_shapes",
    "cost_pass",
    "reachability_pass",
    "CODE_BUDGET_COLOCATION",
    "CODE_IR_VERSION",
    "CODE_OVER_BUDGET",
    "CODE_UNPLACEABLE",
]
