"""aAPP — the paper's contribution: language, semantics, state, fast path.

v2 surface: the explicit compile pipeline (:mod:`repro.core.compile`),
structured :class:`Decision` results (:mod:`repro.core.decision`), the
pluggable strategy registry (:mod:`repro.core.strategies`) — all fronted by
:class:`repro.platform.Platform`.  The v1 entry points remain importable;
``schedule`` is a thin deprecation shim.
"""
from .ast import (
    AAppError,
    AAppScript,
    Affinity,
    Block,
    CostSpec,
    Invalidate,
    SchedulingFailure,
    TagPolicy,
    default_policy,
)
from .parser import parse, parse_file, to_text
from .scheduler import (
    Warmth,
    candidate_blocks,
    decide,
    default_rng,
    explain,
    rejection_reason,
    schedule,
    seed_default_rng,
    try_schedule,
    valid,
)
from .decision import BlockTrace, Decision, WorkerVerdict
from .strategies import (
    SelectionContext,
    Strategy,
    get_strategy,
    register_strategy,
    strategy_names,
)
from .state import Activation, ClusterState, Conf, Registry, WorkerView, ConcurrencyConflict
from .baseline import schedule_vanilla, try_schedule_vanilla
from .batched import (
    CompiledPolicies,
    SchedulerSession,
    StateTensors,
    TagIndex,
    TagRows,
    WaveResult,
    schedule_wave,
)
from .compile import (
    CompiledScript,
    CompileError,
    Diagnostic,
    IR_VERSION,
    ResolvedPolicy,
    ZonePlan,
    compile_script,
    diagnostic_sort_key,
    require_ir,
    sort_diagnostics,
    zone_plan,
)
from .sharded import ShardedSession, ZoneView

__all__ = [
    "AAppError", "AAppScript", "Affinity", "Block", "Invalidate", "SchedulingFailure",
    "TagPolicy", "default_policy", "parse", "parse_file", "to_text", "schedule",
    "try_schedule", "valid", "candidate_blocks", "Activation", "ClusterState", "Conf",
    "Registry", "WorkerView", "ConcurrencyConflict", "schedule_vanilla",
    "try_schedule_vanilla", "CompiledPolicies", "SchedulerSession", "TagIndex",
    "TagRows", "StateTensors", "schedule_wave", "WaveResult", "Warmth",
    # v2 surface
    "decide", "explain", "rejection_reason", "default_rng", "seed_default_rng",
    "Decision", "BlockTrace", "WorkerVerdict",
    "Strategy", "SelectionContext", "get_strategy", "register_strategy",
    "strategy_names",
    "CompiledScript", "CompileError", "Diagnostic", "IR_VERSION",
    "ResolvedPolicy", "compile_script",
    # v4 analysis surface
    "CostSpec", "require_ir", "sort_diagnostics", "diagnostic_sort_key",
    # v3 zone-sharded control plane
    "ZonePlan", "zone_plan", "ShardedSession", "ZoneView",
]
