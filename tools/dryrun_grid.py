#!/usr/bin/env python3
"""The dry run over the reference's whole grid, and where the largest
peaks sit.

    python3 tools/dryrun_grid.py [--device cuda|cpu] [--jobs N] [--out DIR]

Prints the host (the card's name and power limit where ``nvidia-smi``
answers, Python and torch versions; first, last, and into
``DIR/host.txt``), then runs ``python -m repro_torch.launch.dryrun --arch
all --shape all --mesh both --subprocess --jobs N`` into ``DIR``, prints
its records as one table (``tools/dryrun_table.py``), and runs
``tools/dryrun_peak.py`` on every cell whose per-device peak is above
the card's 80 GB, ``N`` at once, each probe's output
in ``DIR/peak_<cell>.log`` and its first lines printed.  Exits 1 if a run
of the grid or a probe failed.
"""
import argparse
import json
import os
import platform
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: the grid's processes: the port on the path, one compute thread each
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
#: the cells probed: those whose peak a device is over one card's memory
CARD_BYTES = 80e9


def run_all(cmds, jobs: int) -> list:
    """``[(cmd, log path)]``, ``jobs`` at once; their return codes."""
    waiting, running, rcs = list(enumerate(cmds)), {}, [None] * len(cmds)
    while waiting or running:
        while waiting and len(running) < jobs:
            i, (cmd, log) = waiting.pop(0)
            with open(log, "w") as f:
                running[i] = subprocess.Popen(cmd, cwd=ROOT, env=ENV,
                                              stdout=f,
                                              stderr=subprocess.STDOUT)
        time.sleep(0.5)
        for i, p in list(running.items()):
            if p.poll() is not None:
                rcs[i] = running.pop(i).returncode
    return rcs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--out", default="build/dryrun_grid")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    import torch

    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        card = "no nvidia-smi"
    host = (f"host: {card}; python {platform.python_version()}, torch "
            f"{torch.__version__}")
    (out / "host.txt").write_text(host + "\n")
    print(host, flush=True)

    t0 = time.perf_counter()
    grid = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "all",
         "--shape", "all", "--mesh", "both", "--subprocess", "--jobs",
         str(args.jobs), "--device", args.device, "--out", str(out)],
        cwd=ROOT, env=ENV)
    print(f"grid: rc {grid.returncode} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    subprocess.run([sys.executable, str(ROOT / "tools" / "dryrun_table.py"),
                    str(out)], cwd=ROOT)

    big = []
    for path in sorted(out.glob("*.json")):
        rec = json.loads(path.read_text())
        if rec["status"] == "ok" and \
                rec["memory"]["peak_bytes"] > CARD_BYTES:
            big.append((rec["arch"], rec["shape"],
                        "multi" if rec["mesh"].count("x") == 2
                        else "single"))
    cmds = [([sys.executable, str(ROOT / "tools" / "dryrun_peak.py"), a, s,
              m, "--device", args.device],
             out / f"peak_{a}_{s}_{m}.log") for a, s, m in big]
    t0 = time.perf_counter()
    rcs = run_all(cmds, args.jobs)
    print(f"probes: {len(cmds)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for (cmd, log), rc in zip(cmds, rcs):
        lines = [x for x in Path(log).read_text().splitlines()
                 if not x.startswith(("[rank", "  File", "    "))]
        print(f"== {' '.join(cmd[2:5])}: rc {rc}")
        print("\n".join(lines[:18]), flush=True)
    print(host, flush=True)
    return 1 if grid.returncode or any(rcs) else 0


if __name__ == "__main__":
    sys.exit(main())
