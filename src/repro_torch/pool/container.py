"""Container lifecycle primitives.

A *container* is the unit of state the warm pool manages: one sandbox able to
run one function at a time on one worker.  Lifecycle (OpenWhisk terminology,
mirrored by the ColdBot-style scheduler in the related work):

* **cold** — no container exists: the platform must create one (image pull,
  sandbox boot, runtime init) before the invocation runs;
* **warm** — an idle container for the function exists on the worker but has
  been paused; resuming it costs an unpause, far cheaper than a cold start;
* **hot**  — an idle container that finished another invocation moments ago
  and is still running (pre-pause grace window): reuse is essentially free.

The pool only ever holds IDLE containers; a container handed out by
``WarmPool.acquire`` is BUSY until ``release`` returns it (or ``destroy``
retires it).
"""
from __future__ import annotations

import dataclasses
import enum
import itertools


class ContainerState(enum.Enum):
    IDLE = "idle"
    BUSY = "busy"
    MIGRATING = "migrating"  # detached from its source worker, in transfer
    DEAD = "dead"


_ids = itertools.count()


@dataclasses.dataclass
class Container:
    """One function sandbox resident on a worker."""

    function: str
    tag: str
    worker: str
    memory: float
    created_at: float
    cid: str = dataclasses.field(default_factory=lambda: f"c{next(_ids)}")
    state: ContainerState = ContainerState.BUSY
    last_used: float = 0.0  # when it last went idle
    uses: int = 0  # invocations served
    prewarmed: bool = False  # started speculatively; cleared on first hit
    park_rev: int = 0  # bumped on every park/unpark; lazy expiry entries
    #                    (WarmPool's janitor heap) validate against it

    def idle_for(self, now: float) -> float:
        return max(0.0, now - self.last_used)
