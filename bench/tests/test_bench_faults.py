"""A whole run of the harness, past its look for a card, with the timed
path broken underneath in each way a prefill cell can be
(``bench/tests/faults.py``): ``correct`` comes out false, and true when
nothing is broken.

On the CPU at the small configurations against the small limits; on the
card (marked ``cuda``) at each cell's own configuration and traffic
against its committed limits, with a short window.  On the card the
``half`` fault is not held: a cell serves one prompt at a time, so it has
no half of a batch to leave out, and the last position of falcon-mamba-7b
at random weights hardly depends on the first half of its prompt (the
readings are in PERF.md)."""
import gc
import os
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", 1))))

from bench.harness import results, spec  # noqa: E402
from bench.tests import faults, small  # noqa: E402

CELLS = sorted(small.CELLS)


def run(cell_name, seed=2**31 + 99):
    bench = spec.benchmark()
    cell = small.CELLS[cell_name]
    return results.run_cell(bench, cell, seed=seed, seconds=0.3,
                            trace=False, device=torch.device("cpu"),
                            t_start=time.perf_counter(),
                            config=small.config(cell["config"]),
                            mix=small.mix(), limits=small.LIMITS)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = run(cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_caught(cell, fault, monkeypatch):
    faults.plant(fault, monkeypatch)
    out = run(cell)
    number = faults.CAUGHT_BY[fault]
    assert not out["correct"]
    assert out["checks"][number]["value"] > small.LIMITS[number]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["layer"])
@pytest.mark.parametrize("cell_name", [w["name"] for w in
                                       spec.benchmark()["workloads"]])
def test_a_planted_fault_fails_the_cells_limits_on_the_card(
        card, cell_name, fault, monkeypatch):
    bench = spec.benchmark()
    cell = spec.cell(bench, cell_name)
    faults.plant(fault, monkeypatch)
    number = faults.CAUGHT_BY[fault]
    for seed in (2**31 + 21, 2**31 + 22, 2**31 + 23):
        out = results.run_cell(bench, cell, seed=seed, seconds=5,
                               trace=False, device=torch.device("cuda"),
                               t_start=time.perf_counter())
        print(f"fault {fault} in {cell_name}, seed {seed}: {number} "
              f"{out['checks'][number]['value']!r} "
              f"(limit {out['checks'][number]['limit']!r})", flush=True)
        assert not out["correct"], (seed, out["checks"])
        del out
        gc.collect()
        torch.cuda.empty_cache()
