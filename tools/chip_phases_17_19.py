#!/usr/bin/env python3
"""Phases 17 to 19 of ``chip_smoke.py`` alone, on one NVIDIA card.

    python3 tools/chip_phases_17_19.py

Starts the three full-size dry runs in the background (``chip_smoke.
start_dryruns``), then on the card: phase 17's training (``train_path``:
gemma3-4b whole, its step's peak counted on ``meta`` and measured), the
oracle against one gemma3-4b and one falcon-mamba-7b prefill, phase 17's
counted train step priced, the (1, 1) DTensor prefill, and phase 19's
training (``ssm_train_path``, its peak counted and measured as phase
17's); then collects the dry runs.  Each part prints one JSON line, or its
traceback, and the next part runs all the same; the exit code is 1 if any
part failed.  No kernel is built: none of these parts launches one.
"""
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card} (torch {torch.__version__})", flush=True)
    out = Path(tempfile.mkdtemp(prefix="phases_18_19_"))
    started = time.perf_counter()
    procs = cs.start_dryruns(out)
    failed = []

    def part(name, fn):
        t0 = time.perf_counter()
        try:
            got = fn()
            print(f"{name} ({time.perf_counter() - t0:.1f} s): "
                  f"{json.dumps(got, default=str)}", flush=True)
        except Exception:  # report and go on to the next part
            failed.append(name)
            print(f"{name} FAILED ({time.perf_counter() - t0:.1f} s):\n"
                  f"{traceback.format_exc()}", flush=True)
        finally:
            gc.collect()
            torch.cuda.empty_cache()

    train = {}
    part("training", lambda: train.update(cs.train_path()) or train)
    if train:
        print(cs.peak_line(train["whole"], card), flush=True)
    part("oracle gemma3-4b", lambda: cs.oracle_vs_card(cs.GEMMA3_4B, 31))
    part("oracle falcon-mamba-7b", lambda: cs.oracle_vs_card(
        cs.FALCON_MAMBA_7B, 32, scan_impl="chunked"))
    if train:
        part("train-step bound", lambda: cs.train_step_counted_bound(
            train["whole"]))
    part("DTensor prefill", lambda: cs.dtensor_prefill(cs.GEMMA3_4B))
    ssm = {}
    part("ssm training", lambda: ssm.update(cs.ssm_train_path()) or ssm)
    if ssm:
        print(cs.peak_line(ssm["whole"], card), flush=True)
    part("dry runs", lambda: cs.collect_dryruns(procs, out, started))
    print(card)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
