"""One run of one benchmark cell on the port (``repro_torch``):

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It loads, warms up, measures for ``--seconds``, checks what the window
produced against the plain reference, and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` a ``breakdown``, and ``checks`` (each number
compared, with its limit), which also close standard error.  Every piece
is found by name from ``BENCHMARK.json`` (``bench/harness/spec.py``).  It
needs as many CUDA devices as the cell asks for, and exits with code 2
and no result without them.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.harness import env  # noqa: E402

env.pin_caches(ROOT)

from bench.harness import results, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    torch = env.require_cards(cell["chips"])
    out = results.run_cell(bench, cell, seed=args.seed, seconds=args.seconds,
                           trace=bool(args.trace),
                           device=torch.device("cuda"), t_start=T_START)
    sys.stderr.write(results.card_line(torch) + "\n")
    found = env.forbidden_modules()
    if found:
        sys.stderr.write("the process loaded JAX or the JAX package: "
                         + ", ".join(found) + "\n")
        return 3
    results.emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
