"""Where the benchmark's pieces live, and how they are found by name.

``BENCHMARK.json`` at the root of the checkout names every cell, metric and
configuration.  Everything that belongs to one of them is a file of its own
under ``bench/``, found from that name alone:

* a configuration:      ``bench/configs/<config name>.json``
* a traffic mix:        ``bench/traffic/<traffic name>.json``
* a metric (a reader):  ``bench/metrics/<metric name>.py``
* an entry kind:        ``bench/entries/<kind>.py`` (the traffic names it)
* a reference family:   ``bench/reference/<family>.py`` (the config names it)
* a cell's limits:      ``bench/limits/<cell name>.json``
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    known = ", ".join(w["name"] for w in spec["workloads"])
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json ({known})")


def config(name: str) -> dict:
    return read_json(BENCH / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return read_json(BENCH / "traffic" / f"{name}.json")


def limits(cell_name: str) -> dict:
    return read_json(BENCH / "limits" / f"{cell_name}.json")


def load_file(path: Path, module_name: str) -> ModuleType:
    """A module loaded from its file, under ``module_name`` (metric files
    carry dots in their names, so they are not imported as packages)."""
    if module_name in sys.modules:
        return sys.modules[module_name]
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str) -> ModuleType:
    return load_file(BENCH / "metrics" / f"{name}.py",
                     f"bench_metric_{name.replace('.', '_')}")


def entry(kind: str) -> ModuleType:
    return importlib.import_module(f"bench.entries.{kind}")


def reference(family: str) -> ModuleType:
    return importlib.import_module(f"bench.reference.{family}")


def applies(metric: dict, cell_name: str, reported: Optional[set] = None
            ) -> bool:
    """Whether ``metric`` is read in ``cell_name``: listed under its
    ``workloads``, or, without that key, wherever the cell reports the
    end-to-end metric it moves (``reported``; every cell for an end-to-end
    metric without the key)."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    if reported is None or "moves" not in metric:
        return True
    return metric["moves"] in reported


def metrics_for(spec: dict, cell_name: str, trace: bool) -> List[dict]:
    e2e = [m for m in spec["end_to_end"] if applies(m, cell_name)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"] if applies(m, cell_name, names)]

