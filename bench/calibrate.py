"""The readings the limits of ``correct`` are set from, on the card:

    python3 bench/calibrate.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...] --control-seeds <n> [<n> ...]

For each seed, in one process: a run of the cell with a window of
``--seconds`` and the check of its compared requests (the program's
readings); on the control seeds the same requests also go through the
reference one precision down (fp8 linear layers in place of bf16), whose
readings have to fail the limits.  Writes one JSON line a seed to
``chiprun_out/calibrate-<cell>.jsonl`` and the largest program reading and
smallest control reading of each number last on standard output.  The
benchmark's runs never run the control.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
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
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=())
    args = ap.parse_args(argv)

    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    torch = env.require_cards(cell["chips"])
    print(results.card_line(torch), flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    path = out_dir / f"calibrate-{cell['name']}.jsonl"
    program, control = {}, {}
    for seed in dict.fromkeys([*args.seeds, *args.control_seeds]):
        t0 = time.perf_counter()
        out = results.run_cell(bench, cell, seed=seed, seconds=args.seconds,
                               trace=False, device=torch.device("cuda"),
                               t_start=t0,
                               control=seed in args.control_seeds)
        row = {"seed": seed, "correct": out["correct"],
               "attempted": out["attempted"], "checks": out["checks"],
               "metrics": out["metrics"],
               "seconds": time.perf_counter() - t0}
        with open(path, "a") as f:
            f.write(json.dumps(results.finite(row)) + "\n")
        print(json.dumps(results.finite(row)), flush=True)
        for k, c in out["checks"].items():
            if seed in args.seeds:
                program.setdefault(k, []).append(c["value"])
            if "control" in c:
                control.setdefault(k, []).append(c["control"])
        del out
        gc.collect()
        torch.cuda.empty_cache()
    summary = {k: {"program_max": max(v), "program": v,
                   "control_min": min(control[k]) if k in control else None,
                   "control": control.get(k, [])}
               for k, v in program.items()}
    print(json.dumps({"cell": cell["name"], "readings": summary,
                      "process_s": time.perf_counter() - T_START}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
