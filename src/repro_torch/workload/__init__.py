"""Trace-driven workload scenarios (Poisson / bursty / diurnal / chained DAG
/ multi-region skewed diurnal) and the open-loop driver that replays them
onto the cluster simulator."""
from .traces import (
    Arrival,
    bursty_trace,
    chained_trace,
    diurnal_trace,
    multiregion_trace,
    overload_trace,
    poisson_trace,
)
from .driver import InvocationRecord, TraceWorkload, affine_terms_of
from .replay import (
    ReplayConfig,
    RunResult,
    WhatIfDiff,
    diff_runs,
    replay_identical,
    run_config,
    validate_replay_timeline,
    whatif,
)
from .scenarios import (
    COMPUTE_S,
    FUNCTION_MIX,
    MULTIREGION,
    MULTIREGION_ZONES,
    SCENARIOS,
    build_trace,
    register_functions,
)

__all__ = [
    "Arrival", "poisson_trace", "bursty_trace", "diurnal_trace",
    "chained_trace", "multiregion_trace", "overload_trace",
    "InvocationRecord",
    "TraceWorkload", "affine_terms_of",
    "SCENARIOS", "MULTIREGION", "MULTIREGION_ZONES", "FUNCTION_MIX",
    "COMPUTE_S", "build_trace", "register_functions",
    "ReplayConfig", "RunResult", "WhatIfDiff", "diff_runs",
    "replay_identical", "run_config", "validate_replay_timeline", "whatif",
]
