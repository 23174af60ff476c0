"""Overload & failure resilience — admission, fairness, retry, chaos.

One :class:`Resilience` bundle threaded through the platform facade and
the workload driver, mirroring :class:`repro_torch.obs.Obs`'s
zero-overhead-when-disabled shape:

* ``Resilience()`` is the **disabled** bundle — every sub-component is
  ``None``, consumers keep ``None`` references and their hot paths pay a
  single ``is not None`` check (``benchmarks/overhead.py --resilience``
  pins the disabled facade tax under 1%, and decisions + rng draws stay
  bit-identical — property-tested);
* :meth:`Resilience.enabled` builds the live layer: per-tenant
  token-bucket admission with SLO-aware shedding
  (:class:`~repro_torch.resilience.admission.AdmissionController`),
  weighted-fair queueing with bounded per-tenant backlogs
  (:class:`~repro_torch.resilience.fairness.FairQueue`), and retry/backoff of
  lost work (:class:`~repro_torch.resilience.retry.RetryPolicy` +
  :class:`~repro_torch.resilience.retry.RetryLedger`).

:mod:`repro_torch.resilience.chaos` supplies the fault-injection harness the
``benchmarks/overload.py`` scenarios (and the CI chaos smoke) run.

Quick start::

    from repro_torch.resilience import Resilience, TenantPolicy
    from repro_torch.workload import TraceWorkload

    res = Resilience.enabled(
        tenants={"gold": TenantPolicy(weight=2.0, rate=20.0)},
        default=TenantPolicy(rate=5.0), slo=obs.slo)
    wl = TraceWorkload(sim, plat.placer(rng), COMPUTE_S,
                       resilience=res)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

from .admission import (
    ADMIT,
    SHED_RATE,
    SHED_SLO,
    DEFAULT_TENANT,
    AdmissionController,
    TenantPolicy,
    TokenBucket,
)
from .fairness import FairQueue
from .retry import RetryLedger, RetryPolicy
from .chaos import (
    Fault,
    ChaosHarness,
    KILL_WORKER,
    KILL_ZONE,
    HEAL_WORKER,
    HEAL_ZONE,
)

__all__ = [
    "Resilience", "LostActivation",
    "AdmissionController", "TenantPolicy", "TokenBucket", "DEFAULT_TENANT",
    "ADMIT", "SHED_RATE", "SHED_SLO",
    "FairQueue", "RetryPolicy", "RetryLedger",
    "Fault", "ChaosHarness",
    "KILL_WORKER", "KILL_ZONE", "HEAL_WORKER", "HEAL_ZONE",
]


@dataclasses.dataclass(frozen=True)
class LostActivation:
    """What a failed worker was running when it died — the structured
    record :meth:`repro_torch.platform.Platform.fail_worker` and the workload
    driver return instead of the bare state-table eviction."""

    activation_id: str
    function: str
    tag: str
    worker: str
    tenant: str = DEFAULT_TENANT
    elapsed: float = 0.0  # seconds in flight when the worker died


class Resilience:
    """The resilience bundle: optional admission controller, fair queue,
    retry policy (+ its per-tenant ledger), and the shared loss counters.

    ``Resilience()`` is the disabled shape (all sub-components ``None``,
    :attr:`active` false)."""

    def __init__(self, *, admission: Optional[AdmissionController] = None,
                 queue: Optional[FairQueue] = None,
                 retry: Optional[RetryPolicy] = None):
        self.admission = admission
        self.queue = queue
        self.retry = retry
        self.ledger = RetryLedger() if retry is not None else None
        # driver-maintained loss accounting (never None — cheap ints)
        self.permanent_lost = 0  # activations that exhausted every rescue
        self.queue_shed = 0  # arrivals refused by a full tenant backlog

    @property
    def active(self) -> bool:
        return (self.admission is not None or self.queue is not None
                or self.retry is not None)

    @classmethod
    def enabled(cls, *, tenants: Optional[Mapping[str, TenantPolicy]] = None,
                default: TenantPolicy = TenantPolicy(), slo=None,
                budget_floor: float = 0.0, pressure_depth: int = 1,
                retry: Optional[RetryPolicy] = RetryPolicy(),
                queue: bool = True) -> "Resilience":
        """The full layer: admission (+ SLO-aware shed when ``slo`` is an
        :class:`~repro_torch.obs.slo.SloEngine`), a weighted-fair queue sharing
        the admission policies, and retry/backoff (pass ``retry=None`` to
        disable rescue, ``queue=False`` to dispatch immediately)."""
        adm = AdmissionController(tenants, default=default, slo=slo,
                                  budget_floor=budget_floor,
                                  pressure_depth=pressure_depth)
        return cls(admission=adm,
                   queue=FairQueue(adm.policy) if queue else None,
                   retry=retry)

    def policy(self, tenant: str) -> TenantPolicy:
        if self.admission is not None:
            return self.admission.policy(tenant)
        return TenantPolicy()

    # ---- read surfaces ---------------------------------------------------- #

    def snapshot(self) -> Dict:
        """The ``shed / retries / queue_depth`` counter block surfaced by
        ``Platform.stats()["resilience"]`` and the Prometheus render
        (per-tenant admission counters nested under ``tenants``)."""
        out: Dict = {
            "shed": self.queue_shed + (self.admission.shed
                                       if self.admission is not None else 0),
            "queue_shed": self.queue_shed,
            "retries": (self.ledger.total_retries
                        if self.ledger is not None else 0),
            "permanent_lost": self.permanent_lost,
            "queue_depth": (self.queue.depth
                            if self.queue is not None else 0),
            "queue_max_depth": (self.queue.max_depth
                                if self.queue is not None else 0),
        }
        if self.admission is not None:
            out["admitted"] = self.admission.admitted
            out["tenants"] = self.admission.snapshot()
        return out

    def register_into(self, registry, prefix: str = "resilience") -> None:
        """Register as a snapshot-time collector (the obs plane's pattern:
        nothing runs on the decision path)."""
        registry.register_collector(prefix, self.snapshot)
