"""Latency attribution — where every microsecond of an invocation went.

The paper's claim is about *latency*: affinity-aware placement improves
end-to-end performance and the aAPP layer adds no noticeable overhead.  A
single opaque ``latency`` float per invocation cannot adjudicate that — the
predictive strategy (ROADMAP item 3) trades a cold start against a shorter
queue, and SLO-aware overload work (item 5) needs to know whether p99 is
boot, contention or wide-area routing.  This module decomposes each
activation's end-to-end latency, on the simulator's virtual clock, into the
named components of :data:`COMPONENTS`:

``sched``
    platform scheduling/routing overhead (the OpenWhisk front-door cost,
    ``SimParams.invoke_overhead``) — the paper's "no noticeable overhead"
    term;
``boot``
    container start: the cold/warm/hot latency charged by the warm pool;
``migrate``
    migration hand-off charged *on the invocation path*.  Planner-driven
    migrations currently detach/attach in the background (charged to
    ``PoolMetrics.migration_seconds``), so this component reads 0.0 until a
    policy makes an invocation wait on an in-flight transfer — it is part
    of the taxonomy so replays and dashboards keep a stable shape;
``route``
    wide-area cost: the worker zone's distance from the control plane
    (the paper's EU/US asymmetry) plus the cross-zone front-door hop for
    zone-stamped arrivals placed remotely (and, when a workload charges
    replication-lag waits to an invocation, that wait too);
``service``
    processor-sharing compute — the span between the compute phase's begin
    stamp and its completion, contention included;
``parent_wait``
    DAG parent wait: for chained children, the time between the *root*
    arrival of the chain and this child's spawn (the parent's own
    end-to-end latency as seen by the child).  0.0 for roots and plain
    arrivals.

**Exact-sum invariant.**  For every record, the canonical component sum
(:func:`total`) equals the record's end-to-end latency *bit-exactly*:
``total(components) == latency + components["parent_wait"]`` — i.e.
``sum(components) == latency`` for every non-chained record, and for
chained children the ``parent_wait`` component extends the measured window
back to the root arrival.  Float addition is not associative, so
:func:`build` closes the budget onto the ``service`` component: service is
measured from the stamped compute-begin boundary and then adjusted by the
(sub-nanosecond) float residue until the canonical sum reproduces the
latency exactly.  :func:`check` enforces the invariant per record and is
what the property tests and the what-if replay diff run on.

Aggregates flow into :class:`repro_torch.obs.MetricsRegistry` fixed-bucket
histograms per *(function, component, zone)* via :class:`LatencyAttributor`
(names ``attr.<zone>.<function>.<component>_s``), and
``benchmarks/report.py --attribution`` renders the per-scenario breakdown
table.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

#: the component taxonomy, in canonical summation order.  ``service`` closes
#: the execution-window sum (it is the residual absorber of the exact-sum
#: invariant); ``parent_wait`` is added last, *outside* the execution
#: window, so the canonical total is literally the float expression
#: ``latency + parent_wait`` once the window closes onto ``latency``.
COMPONENTS: Tuple[str, ...] = (
    "sched", "boot", "migrate", "route", "service", "parent_wait")

#: the execution-window components (everything inside ``latency``).
_WINDOW = COMPONENTS[:-1]


def total(components: Mapping[str, float]) -> float:
    """Canonical left-associative sum in :data:`COMPONENTS` order — the
    one float expression the exact-sum invariant is defined over."""
    t = 0.0
    for name in COMPONENTS:
        t += components[name]
    return t


def e2e_latency(record) -> float:
    """End-to-end latency of a record's attribution window: its ``latency``
    plus the ``parent_wait`` component (for chained children the window
    starts at the root arrival; for everything else this is ``latency``)."""
    c = record.components
    pw = c["parent_wait"] if c is not None else 0.0
    return record.latency + pw


def _window_sum(comps: Mapping[str, float]) -> float:
    t = 0.0
    for name in _WINDOW:
        t += comps[name]
    return t


def build(*, sched: float, boot: float, migrate: float, route: float,
          service: float, parent_wait: float,
          latency: float) -> Dict[str, float]:
    """Assemble a component dict whose canonical sum reproduces
    ``latency + parent_wait`` bit-exactly.

    ``service`` arrives *measured* (completion time minus the stamped
    compute-begin boundary); the other components are the exact charges the
    simulator levied.  Because float addition is not associative, the
    measured parts can re-sum to within a few ulp of — but not exactly —
    the latency, so the residue is folded into ``service`` until the
    execution-window sum equals ``latency`` exactly (the canonical total is
    then the identical float expression ``latency + parent_wait``).  One
    wrinkle: when the window's partial sum sits exactly half an ulp off the
    target's grid, every candidate total is a round-to-even tie and no
    ``service`` value can land — ``boot`` is then perturbed by the
    half-ulp-scale residue to break the tie alignment and the closure
    retried.  All adjustments are orders of magnitude below any physical
    quantity in the model, so downstream consumers get exact equality
    instead of tolerances."""
    comps = {"sched": sched, "boot": boot, "migrate": migrate,
             "route": route, "service": service, "parent_wait": parent_wait}
    for _ in range(32):
        prev = None
        for _ in range(8):
            diff = latency - _window_sum(comps)
            if diff == 0.0:
                return comps
            new = comps["service"] + diff
            if new == comps["service"] or new == prev:
                break  # stuck below ulp, or oscillating across a tie
            prev = comps["service"]
            comps["service"] = new
        comps["boot"] += (latency - _window_sum(comps)) / 2.0
    raise ArithmeticError(
        f"attribution residual failed to close: {comps} vs {latency}")


def check(record) -> None:
    """Assert the exact-sum invariant on one :class:`InvocationRecord`
    (skips failed records, which carry no components)."""
    if record.failed:
        return
    c = record.components
    assert c is not None, f"record for {record.function!r} has no components"
    missing = [k for k in COMPONENTS if k not in c]
    assert not missing, f"components missing {missing}"
    got = total(c)
    want = record.latency + c["parent_wait"]
    assert got == want, (
        f"exact-sum violated for {record.function!r}: "
        f"sum(components)={got!r} != latency+parent_wait={want!r} ({c})")


class LatencyAttributor:
    """Streams per-record component values into registry histograms.

    One fixed-bucket histogram per *(zone, function, component)*, named
    ``<prefix>.<zone>.<function>.<component>_s`` (``all`` when the worker
    is unzoned).  Histogram handles are cached so the per-record cost is a
    dict lookup plus one ``observe`` per non-zero component."""

    def __init__(self, registry, prefix: str = "attr"):
        self.registry = registry
        self.prefix = prefix
        self._hist: Dict[Tuple[str, str, str], object] = {}

    def observe(self, record, zone: Optional[str] = None) -> None:
        c = record.components
        if record.failed or c is None:
            return
        z = zone if zone else "all"
        f = record.function
        for name in COMPONENTS:
            key = (z, f, name)
            h = self._hist.get(key)
            if h is None:
                h = self.registry.histogram(
                    f"{self.prefix}.{z}.{f}.{name}_s")
                self._hist[key] = h
            h.observe(c[name])


def summarize(records, *, by: str = "component") -> Dict[str, Dict[str, float]]:
    """Aggregate a record stream into mean seconds per component (the
    ``report.py --attribution`` table shape).  ``by="function"`` nests the
    breakdown per function instead of pooling the whole stream."""
    groups: Dict[str, Dict[str, float]] = {}
    counts: Dict[str, int] = {}
    for r in records:
        if r.failed or r.components is None:
            continue
        key = r.function if by == "function" else "all"
        g = groups.setdefault(key, {k: 0.0 for k in COMPONENTS})
        for k in COMPONENTS:
            g[k] += r.components[k]
        counts[key] = counts.get(key, 0) + 1
    out: Dict[str, Dict[str, float]] = {}
    for key, sums in groups.items():
        n = counts[key]
        row = {k: sums[k] / n for k in COMPONENTS}
        row["e2e"] = sum(sums[k] for k in COMPONENTS) / n
        row["n"] = n
        out[key] = row
    return out
