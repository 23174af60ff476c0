"""A run from its cell to its result line: find the cell's pieces by name,
hand them to the entry kind, read each metric from what the run recorded,
and decide ``correct`` from the checks."""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from types import SimpleNamespace

from bench.harness import spec


def card_line(torch) -> str:
    """The card's name and power limit, beside every number a run keeps."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = "power limit not read"
    return f"card: {torch.cuda.get_device_name(0)}; nvidia-smi: {out}"


def run_cell(bench: dict, cell: dict, *, seed: int, seconds: float,
             trace: bool, device, t_start: float, config=None, mix=None,
             limits=None, control: bool = False) -> dict:
    """One run of ``cell``; ``config``, ``mix`` and ``limits`` default to
    the files the cell names (tests hand in smaller ones)."""
    config = config or spec.config(cell["config"])
    mix = mix or spec.traffic(cell["traffic"])
    ctx = SimpleNamespace(
        cell=cell, config=config, mix=mix,
        family=spec.reference(config["reference"]),
        limits=limits or spec.limits(cell["name"]), seed=seed,
        seconds=seconds, trace=trace, device=device, t_start=t_start,
        control=control, log=lambda msg: log(t_start, msg))
    got = spec.entry(mix["entry"]).run(ctx)
    ctx.__dict__.update(got)
    window = [r for r in ctx.records if not r.profiled]
    ctx.window = window
    ctx.span_s = max(r.t_done for r in window) - min(r.t_submit
                                                     for r in window)
    metrics = {}
    for m in spec.metrics_for(bench, cell["name"], trace):
        value = spec.metric_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = ctx.checks
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": _device_kind(device), "count": cell["chips"],
           "memory_peak_bytes": ctx.memory_peak_bytes}
    out = {"correct": correct, "attempted": len(ctx.records),
           "failed": sum(1 for r in ctx.records if not r.ok),
           "metrics": metrics,
           "device": dev}
    if trace:
        s = ctx.trace
        dev["busy_s"] = s.busy_s if s else 0.0
        dev["window_s"] = s.window_s if s else 0.0
        if s:
            out["breakdown"] = {"device_ops": s.device_ops(),
                                "idle_gaps": [list(g) for g in s.gaps]}
    out["checks"] = checks
    return out


def log(t_start: float, msg: str) -> None:
    """A line on standard error, with the seconds since the run began."""
    sys.stderr.write(f"[{time.perf_counter() - t_start:8.3f} s] {msg}\n")
    sys.stderr.flush()


def _device_kind(device) -> str:
    if device.type != "cuda":
        return device.type
    import torch

    return torch.cuda.get_device_name(device)


def emit(out: dict) -> None:
    """The checks close standard error; the result line closes standard
    output."""
    for name, c in out["checks"].items():
        sys.stderr.write(f"check {name}: {c['value']!r} (limit "
                         f"{c['limit']!r})\n")
    sys.stderr.flush()
    print(json.dumps(finite(out)), flush=True)


def finite(x):
    """JSON has no infinity: a number that is not finite is written as its
    name."""
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    return x
