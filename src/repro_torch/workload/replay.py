"""Counterfactual what-if replay — rerun a captured trace under a different
policy and attribute every latency delta to its shifted components.

The question every scheduling PR actually argues about is *"what would have
happened under the other policy?"*.  This module makes that a first-class
operation on the simulator:

1. :func:`run_config` runs one fully-specified scenario
   (:class:`ReplayConfig`: scenario + strategy + keep-alive + zone hint +
   seed) with the observability plane attached and captures everything a
   comparison needs — the arrival trace, the per-activation
   :class:`~repro_torch.workload.driver.InvocationRecord` stream (with latency
   attribution components), the tracer's decision log, and the placer rng's
   stream position.
2. :func:`whatif` re-runs the *identical* trace under an alternate config
   and :func:`diff_runs` joins the two record streams on their
   deterministic ``arrival_id`` keys, attributing each latency delta to the
   components that moved (e.g. ``a17/impera0 +0.4s: cold boot it
   previously dodged``).
3. :func:`replay_identical` is the determinism oracle: a replay under the
   *same* config must reproduce every decision, every rng draw, and every
   per-component latency bit-identically — any drift is a bug, and CI
   (``run.py --whatif --quick``) runs exactly this check.

Everything runs on fresh state per call (new pool, simulator, platform,
obs bundle), so two runs never share mutable state and "same config ⇒ same
bits" is a property of the stack, not of call ordering.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.cluster.simulator import ClusterSim, SimParams
from repro_torch.cluster.topology import multizone_testbed, paper_testbed
from repro_torch.obs import Obs, SloEngine
from repro_torch.obs.attribution import COMPONENTS
from repro_torch.obs.trace import validate_chrome_trace
from repro_torch.platform import Platform
from repro_torch.pool import StartCosts, WarmPool, make_policy

from .driver import InvocationRecord, TraceWorkload
from .scenarios import COMPUTE_S, MULTIREGION, build_trace, register_functions
from .traces import Arrival

#: the scenario function mix's tags, in script order (``i`` rides with its
#: affinity term and is appended separately)
_SIMPLE_TAGS = ("api", "img", "etl", "d")

#: multiregion runs charge the heavier wide-area hop (mirrors
#: ``benchmarks/multiregion.py``)
_CROSS_ZONE_ROUTE = 0.35
_ZONES = ("eu", "us", "ap")


@dataclasses.dataclass(frozen=True)
class ReplayConfig:
    """One fully-specified run: everything that can differ between the
    factual and the counterfactual lives here."""

    scenario: str
    strategy: str = "best_first"
    keepalive: str = "fixed_ttl"
    zone_hint: Optional[str] = None  # zone strategy (multiregion only)
    duration: float = 120.0
    rate: float = 2.0
    seed: int = 0
    budget_mb: float = 512.0
    ttl: float = 3.0
    verdicts: bool = False
    slo: Optional[Mapping[str, float]] = None  # fn -> latency threshold


@dataclasses.dataclass(frozen=True)
class RunResult:
    """A captured run: the trace it replayed, its records, the tracer's
    decision log (jsonl), and the placer rng's post-run draws."""

    config: ReplayConfig
    trace: Tuple[Arrival, ...]
    records: Tuple[InvocationRecord, ...]
    jsonl: str
    rng_tail: Tuple[float, ...]
    obs: Obs
    platform: Platform

    def by_id(self) -> Dict[str, InvocationRecord]:
        return {r.arrival_id: r for r in self.records
                if r.arrival_id is not None}

    def latencies(self) -> List[float]:
        return sorted(r.latency for r in self.records if not r.failed)


def build_script(strategy: str, zone_hint: Optional[str] = None) -> str:
    """The scenario-mix aAPP script under a chosen strategy: simple tags
    spread per ``strategy``, ``i`` affine to ``d`` (the paper's co-location
    term), with an optional per-block ``topology:`` zone hint."""
    lines: List[str] = []
    for tag in _SIMPLE_TAGS:
        lines += [f"{tag}:", "  workers: *", f"  strategy: {strategy}"]
        if zone_hint is not None:
            lines.append(f"  topology: {zone_hint}")
    lines += ["i:", "  workers: *", f"  strategy: {strategy}",
              "  affinity: [d]"]
    if zone_hint is not None:
        lines.append(f"  topology: {zone_hint}")
    return "\n".join(lines) + "\n"


def run_config(cfg: ReplayConfig,
               trace: Optional[Sequence[Arrival]] = None, *,
               device="cuda") -> RunResult:
    """Run ``cfg`` on fresh state; with ``trace`` given, replay exactly
    those arrivals instead of regenerating from the scenario name.  The
    platform decides on ``device`` (the port's ``Platform`` default,
    ``"cuda"``; ``"cpu"`` runs the kernels' plain versions)."""
    pool = WarmPool(make_policy(cfg.keepalive, ttl=cfg.ttl),
                    costs=StartCosts(cold=0.5, warm=0.1, hot=0.0),
                    budget_mb=cfg.budget_mb, hot_window=1.0)
    multi = cfg.scenario == MULTIREGION
    topo = multizone_testbed(_ZONES) if multi else paper_testbed()
    params = (SimParams(cross_zone_route=_CROSS_ZONE_ROUTE) if multi
              else SimParams())
    sim = ClusterSim(topo, params, seed=cfg.seed, pool=pool)
    register_functions(sim.registry)
    hint = (cfg.zone_hint or "local_first") if multi else cfg.zone_hint
    obs = Obs.enabled(verdicts=cfg.verdicts, timers=False,
                      slo=SloEngine(cfg.slo) if cfg.slo else None)
    platform = Platform.for_sim(sim, build_script(cfg.strategy, hint),
                                obs=obs, device=device)
    rng = random.Random(cfg.seed + 1)
    wl = TraceWorkload(sim, platform.placer(rng), COMPUTE_S,
                       script=platform.script, obs=obs)
    if trace is None:
        trace = build_trace(cfg.scenario, duration=cfg.duration,
                            rate=cfg.rate, seed=cfg.seed)
    wl.load(trace)
    sim.run()
    # the rng's stream position fingerprints the decision sequence: a
    # replay that drew differently cannot produce the same tail
    tail = tuple(rng.random() for _ in range(4))
    return RunResult(config=cfg, trace=tuple(trace),
                     records=tuple(wl.records), jsonl=obs.tracer.to_jsonl(),
                     rng_tail=tail, obs=obs, platform=platform)


# --------------------------------------------------------------------------- #
# replay identity (the determinism oracle)
# --------------------------------------------------------------------------- #


def replay_identical(a: RunResult, b: RunResult) -> List[str]:
    """Why two runs are *not* bit-identical (empty list: they are).
    Checks decisions (worker per activation), start kinds, latencies and
    every attribution component for exact float equality, plus the full
    decision log bytes and the placer rng stream position."""
    errs: List[str] = []
    ra, rb = a.by_id(), b.by_id()
    if set(ra) != set(rb):
        errs.append(f"activation sets differ: {set(ra) ^ set(rb)}")
    for aid in sorted(set(ra) & set(rb)):
        x, y = ra[aid], rb[aid]
        if x.worker != y.worker:
            errs.append(f"{aid}: worker {x.worker} != {y.worker}")
        if x.start_kind != y.start_kind:
            errs.append(f"{aid}: start {x.start_kind} != {y.start_kind}")
        if x.failed != y.failed:
            errs.append(f"{aid}: failed {x.failed} != {y.failed}")
        if x.tenant != y.tenant:
            errs.append(f"{aid}: tenant {x.tenant} != {y.tenant}")
        if x.failed or y.failed:
            continue
        if x.latency != y.latency:
            errs.append(f"{aid}: latency {x.latency!r} != {y.latency!r}")
        for k in COMPONENTS:
            if x.components[k] != y.components[k]:
                errs.append(f"{aid}: {k} {x.components[k]!r} != "
                            f"{y.components[k]!r}")
    if a.jsonl != b.jsonl:
        errs.append("decision logs differ")
    if a.rng_tail != b.rng_tail:
        errs.append(f"rng stream diverged: {a.rng_tail} != {b.rng_tail}")
    return errs


# --------------------------------------------------------------------------- #
# counterfactual diff
# --------------------------------------------------------------------------- #


def _note(entry: Dict) -> str:
    """One human-readable clause for the biggest shifted component."""
    dom = entry["dominant"]
    d = entry["components_delta"][dom]
    if dom == "boot" and entry["start_kind_a"] != entry["start_kind_b"]:
        if d > 0:
            return (f"{entry['start_kind_b']} boot it previously dodged "
                    f"({entry['start_kind_a']} before)")
        return (f"{entry['start_kind_b']} start instead of "
                f"{entry['start_kind_a']}")
    if dom == "route":
        return ("crossed a zone it previously served locally" if d > 0
                else "served locally instead of crossing zones")
    if dom == "service":
        return ("slower processor-sharing slice (busier worker)" if d > 0
                else "faster processor-sharing slice (quieter worker)")
    if dom == "parent_wait":
        return "parent chain finished " + ("later" if d > 0 else "earlier")
    return f"{dom} shifted {d:+.4f}s"


def diff_runs(a: RunResult, b: RunResult) -> List[Dict]:
    """Per-activation diff ``b - a`` over the shared ``arrival_id`` keys,
    sorted by absolute end-to-end delta (biggest movers first).  Each entry
    carries the per-component deltas, the dominant shifted component, and a
    one-line attribution note."""
    ra, rb = a.by_id(), b.by_id()
    out: List[Dict] = []
    for aid in set(ra) & set(rb):
        x, y = ra[aid], rb[aid]
        if x.failed or y.failed:
            continue
        deltas = {k: y.components[k] - x.components[k] for k in COMPONENTS}
        dominant = max(COMPONENTS, key=lambda k: abs(deltas[k]))
        entry = {
            "arrival_id": aid,
            "function": x.function,
            "worker_a": x.worker, "worker_b": y.worker,
            "start_kind_a": x.start_kind, "start_kind_b": y.start_kind,
            "latency_a": x.latency, "latency_b": y.latency,
            "delta": y.latency - x.latency,
            "components_delta": deltas,
            "dominant": dominant,
        }
        entry["note"] = _note(entry)
        out.append(entry)
    out.sort(key=lambda e: -abs(e["delta"]))
    return out


@dataclasses.dataclass(frozen=True)
class WhatIfDiff:
    base: RunResult
    alt: RunResult
    entries: Tuple[Dict, ...]

    def component_deltas(self) -> Dict[str, float]:
        """Mean per-component latency shift (seconds, alt - base)."""
        n = len(self.entries)
        if n == 0:
            return {k: 0.0 for k in COMPONENTS}
        return {k: sum(e["components_delta"][k] for e in self.entries) / n
                for k in COMPONENTS}

    def mean_delta(self) -> float:
        if not self.entries:
            return 0.0
        return sum(e["delta"] for e in self.entries) / len(self.entries)


def whatif(base: RunResult, **overrides) -> WhatIfDiff:
    """Re-run ``base``'s exact trace under ``dataclasses.replace(config,
    **overrides)`` and diff the outcomes per activation.  The re-run
    decides on ``base``'s device."""
    alt_cfg = dataclasses.replace(base.config, **overrides)
    alt = run_config(alt_cfg, trace=base.trace,
                     device=base.platform._device)
    return WhatIfDiff(base=base, alt=alt,
                      entries=tuple(diff_runs(base, alt)))


# --------------------------------------------------------------------------- #
# timeline export
# --------------------------------------------------------------------------- #


def chrome_trace(run: RunResult) -> Dict:
    """The run's Chrome-trace timeline with latency attribution injected:
    every completed invoke span's ``args`` gains the record's ``components``
    dict and its deterministic ``arrival_id``."""
    by_act = {r.activation_id: r for r in run.records
              if r.activation_id is not None and not r.failed}
    obj = run.obs.tracer.chrome_trace()
    for ev in obj["traceEvents"]:
        if ev.get("cat") == "invoke" and ev.get("ph") == "X":
            r = by_act.get(ev["args"].get("id"))
            if r is not None and r.components is not None:
                ev["args"]["components"] = dict(r.components)
                ev["args"]["arrival_id"] = r.arrival_id
    return obj


def validate_replay_timeline(obj) -> List[str]:
    """:func:`repro_torch.obs.validate_chrome_trace` plus the replay contract:
    every completed invoke span must carry the full component taxonomy in
    its args (the what-if diff joins on exactly these)."""
    errs = validate_chrome_trace(obj)
    if errs:
        return errs
    for i, ev in enumerate(obj.get("traceEvents", [])):
        if ev.get("cat") == "invoke" and ev.get("ph") == "X":
            comps = ev.get("args", {}).get("components")
            if not isinstance(comps, dict):
                errs.append(f"event {i}: invoke span missing components")
                continue
            missing = [k for k in COMPONENTS if k not in comps]
            if missing:
                errs.append(f"event {i}: components missing {missing}")
    return errs
