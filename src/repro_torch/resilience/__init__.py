"""The part of the resilience layer the platform facade needs: the default
tenant name and the structured record of an activation lost to a worker
failure (:meth:`repro_torch.platform.Platform.fail_worker`).

Admission, fair queueing, retry and the chaos harness are not ported yet
(``ROADMAP.md``: the obs and resilience work); the port's ``Platform`` rejects a
non-``None`` ``resilience=`` bundle until they are.
"""
from __future__ import annotations

import dataclasses

DEFAULT_TENANT = "default"

__all__ = ["DEFAULT_TENANT", "LostActivation"]


@dataclasses.dataclass(frozen=True)
class LostActivation:
    """What a failed worker was running when it died — the structured
    record :meth:`repro_torch.platform.Platform.fail_worker` returns instead
    of the bare state-table eviction."""

    activation_id: str
    function: str
    tag: str
    worker: str
    tenant: str = DEFAULT_TENANT
    elapsed: float = 0.0  # seconds in flight when the worker died
