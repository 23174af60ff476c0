"""Per-tenant admission control — token buckets + SLO-aware load shedding.

The front door of the resilience layer (ROADMAP item 5): every *root*
arrival passes :meth:`AdmissionController.admit` before it may enter the
weighted-fair queue.  Two independent shedding mechanisms:

* **rate** — a per-tenant :class:`TokenBucket` (``TenantPolicy.rate``
  requests/second, ``burst`` deep) refilled on the caller's clock (the
  simulator's virtual time here — no wall-clock reads, so runs replay
  bit-identically).  A tenant with no configured rate is never rate-shed.
* **slo** — under backlog pressure (``queue_depth >= pressure_depth``) a
  request whose function has *exhausted its error budget*
  (:meth:`repro_torch.obs.slo.SloEngine.budget_remaining` at or below
  ``budget_floor``) is shed before it can burn the budget further — the
  data-driven admission signal of Przybylski et al. (2105.03217): decide
  against the SLO ledger, not instantaneous state.  Without an SLO engine
  (or for functions carrying no objective) the check is skipped.

Everything is pure bookkeeping on caller-supplied timestamps: no wall
clock, no randomness.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

#: tenant stamp used when an arrival carries none — existing single-tenant
#: traces all map here, which is what keeps them bit-identical
DEFAULT_TENANT = "default"

#: admit() outcomes (the ``reason`` vocabulary of the shed counters)
ADMIT = "ok"
SHED_RATE = "rate"  # token bucket empty
SHED_SLO = "slo"  # error budget exhausted under backlog pressure


@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """Per-tenant knobs shared by admission, fair queueing and retry.

    ``rate``/``burst`` bound the tenant's admitted throughput;  ``weight``
    is its fair-queue share; ``queue_cap`` bounds its backlog (arrivals
    beyond it are shed, not queued — bounded memory under overload);
    ``max_attempts``/``retry_budget`` bound rescue work for its lost
    activations (see :mod:`repro_torch.resilience.retry`)."""

    weight: float = 1.0
    rate: Optional[float] = None  # admitted req/s; None = unlimited
    burst: float = 8.0  # bucket depth, requests
    queue_cap: int = 64  # max queued arrivals for this tenant
    max_attempts: int = 3  # 1 original + up to 2 retries
    retry_budget: float = 0.25  # retries allowed per admitted request

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError("weight must be positive")
        if self.rate is not None and self.rate <= 0:
            raise ValueError("rate must be positive (or None)")
        if self.burst <= 0:
            raise ValueError("burst must be positive")
        if self.queue_cap < 1:
            raise ValueError("queue_cap must be >= 1")


class TokenBucket:
    """The classic shaper: ``rate`` tokens/second up to ``burst``; one
    token per admitted request.  Refill happens lazily on :meth:`allow`,
    from whatever timestamps the caller supplies (monotone per bucket)."""

    __slots__ = ("rate", "burst", "tokens", "last_t")

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.last_t = 0.0

    def allow(self, now: float, cost: float = 1.0) -> bool:
        dt = now - self.last_t
        if dt > 0.0:
            self.tokens = min(self.burst, self.tokens + dt * self.rate)
            self.last_t = now
        if self.tokens >= cost:
            self.tokens -= cost
            return True
        return False


class AdmissionController:
    """Per-tenant token buckets + the SLO-aware shed described above.

    ``policies`` maps tenant -> :class:`TenantPolicy`; unknown tenants get
    ``default``.  ``slo`` is an optional
    :class:`~repro_torch.obs.slo.SloEngine`; ``budget_floor`` is the
    budget-remaining level at (or below) which a function is shed under
    pressure, ``pressure_depth`` the queue backlog that counts as
    pressure."""

    def __init__(self, policies: Optional[Mapping[str, TenantPolicy]] = None,
                 *, default: TenantPolicy = TenantPolicy(), slo=None,
                 budget_floor: float = 0.0, pressure_depth: int = 1):
        self._policies: Dict[str, TenantPolicy] = dict(policies or {})
        self.default = default
        self.slo = slo
        self.budget_floor = float(budget_floor)
        self.pressure_depth = int(pressure_depth)
        self._buckets: Dict[str, TokenBucket] = {}
        # per-tenant counters: {tenant: {"admitted": n, "rate": n, "slo": n}}
        self.counters: Dict[str, Dict[str, int]] = {}

    def policy(self, tenant: str) -> TenantPolicy:
        return self._policies.get(tenant, self.default)

    def _count(self, tenant: str, key: str) -> None:
        row = self.counters.setdefault(
            tenant, {"admitted": 0, SHED_RATE: 0, SHED_SLO: 0})
        row[key] += 1

    def admit(self, tenant: str, function: str, now: float, *,
              queue_depth: int = 0) -> Tuple[bool, str]:
        """One admission verdict: ``(admitted, reason)`` with reason in
        ``{"ok", "rate", "slo"}``.  Counts per tenant either way."""
        pol = self.policy(tenant)
        if pol.rate is not None:
            b = self._buckets.get(tenant)
            if b is None:
                b = self._buckets[tenant] = TokenBucket(pol.rate, pol.burst)
            if not b.allow(now):
                self._count(tenant, SHED_RATE)
                return False, SHED_RATE
        slo = self.slo
        if (slo is not None and queue_depth >= self.pressure_depth
                and function in slo
                and slo.budget_remaining(function) <= self.budget_floor):
            self._count(tenant, SHED_SLO)
            return False, SHED_SLO
        self._count(tenant, "admitted")
        return True, ADMIT

    @property
    def shed(self) -> int:
        return sum(row[SHED_RATE] + row[SHED_SLO]
                   for row in self.counters.values())

    @property
    def admitted(self) -> int:
        return sum(row["admitted"] for row in self.counters.values())

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        """Per-tenant admitted/shed counters (stable key order)."""
        return {t: dict(row) for t, row in sorted(self.counters.items())}
