"""Container lifecycle & warm-pool subsystem (cold/warm/hot starts, keep-alive
policies, janitor, pool metrics) — the worker-state layer the paper's affinity
placement amortises."""
from .container import Container, ContainerState
from .metrics import PoolMetrics
from .policy import (
    AffinityAwareKeepAlive,
    FixedTTLKeepAlive,
    KeepAlivePolicy,
    LCSKeepAlive,
    MRUKeepAlive,
    POLICIES,
    PredictiveKeepAlive,
    make_policy,
)
from .pool import COLD, HOT, StartCosts, WARM, WarmPool

__all__ = [
    "Container", "ContainerState", "PoolMetrics", "KeepAlivePolicy",
    "FixedTTLKeepAlive", "LCSKeepAlive", "MRUKeepAlive",
    "AffinityAwareKeepAlive", "PredictiveKeepAlive", "POLICIES",
    "make_policy", "WarmPool", "StartCosts", "COLD", "WARM", "HOT",
]
