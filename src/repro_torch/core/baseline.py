"""Vanilla-OpenWhisk baseline scheduler.

The paper benchmarks aAPP against unmodified Apache OpenWhisk (§VI), whose
``ShardingContainerPoolBalancer`` picks a *home* invoker by hashing the action
name and then probes invokers at a hash-derived step (co-prime with the pool
size) until one has capacity — favouring warm containers via the stable home
assignment.  We implement that probing scheme so the overhead benchmark
compares the same three systems as Fig. 8: vanilla, APP, aAPP.
"""
from __future__ import annotations

import hashlib
import math
from typing import List, Optional

from .ast import SchedulingFailure
from .state import Conf, Registry


def _hash(name: str) -> int:
    return int.from_bytes(hashlib.sha1(name.encode()).digest()[:8], "big")


def _coprime_step(h: int, n: int) -> int:
    if n <= 1:
        return 1
    step = (h % (n - 1)) + 1
    while math.gcd(step, n) != 1:
        step = step % n + 1
    return step


def schedule_vanilla(f: str, conf: Conf, reg: Registry) -> str:
    """Home-invoker hashing + co-prime probing, capacity-checked."""
    workers: List[str] = list(conf.keys())
    n = len(workers)
    if n == 0:
        raise SchedulingFailure(f"function {f!r}: no invokers")
    spec = reg[f]
    h = _hash(f)
    home = h % n
    step = _coprime_step(h >> 16, n)
    idx = home
    for _ in range(n):
        w = workers[idx]
        view = conf[w]
        if view.memory_used + spec.memory <= view.max_memory:
            return w
        idx = (idx + step) % n
    raise SchedulingFailure(f"function {f!r} not schedulable (pool saturated)")


def try_schedule_vanilla(f: str, conf: Conf, reg: Registry) -> Optional[str]:
    try:
        return schedule_vanilla(f, conf, reg)
    except SchedulingFailure:
        return None
