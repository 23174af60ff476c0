"""Retry/backoff of lost work — capped exponential delays + retry budgets.

``ClusterState.fail_worker`` returns the activations a dead worker was
running "for rescheduling"; before this layer every call site dropped them
on the floor.  :class:`RetryPolicy` is the pure math of rescuing them:

* **hedge-once** — the first retry fires immediately (delay 0): the work
  was already paid for once and the failure signal (a worker death) is
  unambiguous, so there is nothing to wait out;
* **capped exponential backoff** — further retries pay
  ``base_delay * factor**k`` capped at ``max_delay``, the standard
  defence against retry storms when the failure is systemic;
* **per-tenant retry budget** (:class:`RetryLedger`) — the SRE pattern:
  retries may be at most ``retry_budget`` of the tenant's admitted
  traffic (never below one), so a failing dependency cannot turn one
  tenant's load into an amplified cluster-wide storm.  The budget shares
  :class:`~repro_torch.resilience.admission.TenantPolicy` with admission.

The policy is pure configuration + arithmetic (no clocks, no randomness —
deterministic backoff keeps chaos runs replayable); the ledger is plain
counters.  The workload driver owns the actual re-enqueue on the
simulator's event heap.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from .admission import TenantPolicy


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Backoff schedule for re-submitting a lost activation.

    ``attempt`` numbering: the original submission is attempt 1, so the
    first retry is attempt 2.  With ``hedge`` on, attempt 2 is immediate
    and the exponential ladder starts at attempt 3."""

    base_delay: float = 0.25
    factor: float = 2.0
    max_delay: float = 4.0
    hedge: bool = True

    def __post_init__(self):
        if self.base_delay < 0 or self.max_delay < self.base_delay:
            raise ValueError("need 0 <= base_delay <= max_delay")
        if self.factor < 1.0:
            raise ValueError("factor must be >= 1")

    def delay(self, attempt: int) -> float:
        """Seconds to wait before dispatching ``attempt`` (>= 2)."""
        if attempt < 2:
            raise ValueError("delay() is for retries (attempt >= 2)")
        if self.hedge:
            if attempt == 2:
                return 0.0
            k = attempt - 3
        else:
            k = attempt - 2
        return min(self.max_delay, self.base_delay * self.factor ** k)


class RetryLedger:
    """Per-tenant admitted/retry counters enforcing ``retry_budget``."""

    def __init__(self):
        self.admitted: Dict[str, int] = {}
        self.retries: Dict[str, int] = {}

    def note_admitted(self, tenant: str) -> None:
        self.admitted[tenant] = self.admitted.get(tenant, 0) + 1

    def note_retry(self, tenant: str) -> None:
        self.retries[tenant] = self.retries.get(tenant, 0) + 1

    def allowed(self, tenant: str, policy: TenantPolicy) -> bool:
        """True while the tenant's retry spend is inside its budget.  The
        allowance never rounds below one retry — a tenant's very first
        lost activation is always worth one rescue attempt."""
        budget = max(1.0, policy.retry_budget
                     * self.admitted.get(tenant, 0))
        return self.retries.get(tenant, 0) < budget

    @property
    def total_retries(self) -> int:
        return sum(self.retries.values())
