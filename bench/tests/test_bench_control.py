"""The control of ``correct``: the reference itself, put in the program's
place one precision down (fp8 linear layers, ``reference/common.py``),
must fail the limits.

On the CPU, at the small configurations served in float32, against the
small limits: the control fails, the program passes.  On the card (marked
``cuda``; ``python -m pytest bench/tests -m cuda`` there), at each cell's
own size and traffic, on three seeds: the control's readings fail the
cell's committed limits, the program's pass them; each seed's readings
are printed (``-s``)."""
import gc
import os
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", 1))))

from bench.harness import results, spec  # noqa: E402
from bench.tests import small  # noqa: E402

def _fails(checks):
    return any(c["control"] > c["limit"] for c in checks.values()
               if "control" in c)


@pytest.mark.parametrize("cell_name", sorted(small.CELLS))
def test_the_control_fails_the_small_limits(cell_name):
    bench = spec.benchmark()
    cell = small.CELLS[cell_name]
    out = results.run_cell(bench, cell, seed=7, seconds=0.3, trace=False,
                           device=torch.device("cpu"),
                           t_start=time.perf_counter(),
                           config=small.config(cell["config"]),
                           mix=small.mix(), limits=small.LIMITS,
                           control=True)
    checks = out["checks"]
    assert out["correct"], checks
    assert _fails(checks), checks
    assert checks["logit_err"]["control"] > 3 * checks["logit_err"]["value"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", [w["name"] for w in
                                       spec.benchmark()["workloads"]])
def test_the_control_fails_the_cells_limits_on_the_card(card, cell_name):
    bench = spec.benchmark()
    cell = spec.cell(bench, cell_name)
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        out = results.run_cell(bench, cell, seed=seed,
                               seconds=bench["run_seconds"], trace=False,
                               device=torch.device("cuda"),
                               t_start=time.perf_counter(), control=True)
        print(f"control in {cell_name}, seed {seed}: " + ", ".join(
            f"{k} {c['value']!r} control {c['control']!r} limit "
            f"{c['limit']!r}" for k, c in out["checks"].items()
            if "control" in c), flush=True)
        assert out["correct"], (seed, out["checks"])
        assert _fails(out["checks"]), (seed, out["checks"])
        del out
        gc.collect()
        torch.cuda.empty_cache()
