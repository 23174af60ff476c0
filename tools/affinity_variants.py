#!/usr/bin/env python3
"""Time variants of the two affinity kernels on one NVIDIA card.

    python3 tools/affinity_variants.py [--out FILE] [NAME ...]

Each variant is ``src/repro_torch/kernels/affinity/csrc/affinity_common.cuh``
with a few text substitutions (``VARIANTS``): another depth of the row
ring or order of the rows, or one part of the work taken out to see what it
costs (those give wrong outputs on purpose).  Both kernels' sources are
built against the variant's header with ``nvcc``, in a process of its own
(a second library holding the same kernel instances, loaded into one
process, fails its first launch).  For each variant the script prints one
JSON line: its registers and spills, whether both kernels equal their plain
versions bit for bit on ``chip_smoke.AFFINITY_CASES`` (valid, score,
winner), and each kernel's CUDA-event and profiler device ms through its
bare entry at the decision path's shapes (seeded stand-in data: F = 2 and
R = 6 rows, W = 16384, T = 4) and at the 512-tag scale (F = 2 and R = 512,
W = 16384, T = 512).  The card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src/repro_torch/kernels/affinity/csrc"
WORK = ROOT / "build" / "affinity_variants"

_FINISH = ("    finish_row<kBulk, true>(a, in, v, ring.r + (int64_t)kWarps * "
           "decided,\n                            ring.wq, viol, lane);")
_PACK = "    pack_empty_chunk<kWords>(a, e_s, w0, 0, (int)NW, warp, lane);\n"
_VIOL = ("    uint32_t viol = 0;\n#pragma unroll\n    for (int j = 0; j < "
         "kWorkersPerThread; ++j)\n      viol |= (uint32_t)(acc[j] != 0) << "
         "j;")

#: name -> substitutions (old, new) applied to affinity_common.cuh; the
#: variants change the fast path (every shape the scheduler produces)
VARIANTS = {
    "kernel": [],
    # the depth of a warp's ring of row slots
    "stages_4": [("constexpr int kStages = 2;", "constexpr int kStages = 4;")],
    "stages_8": [("constexpr int kStages = 2;", "constexpr int kStages = 8;")],
    # every block takes its rows in the same order
    "no_rotation": [("first(n_ > 0 ? (int)(blockIdx.x % n_) : 0)",
                     "first(0)")],
    # the tile's occ read 8 loads a lane at a time, not 4
    "pack_8_in_flight": [("    constexpr int kU = 4;",
                          "    constexpr int kU = 8;")],
    # the ring's first rows issued after the tile is packed, not before
    "prologue_after_pack": [
        ("    ring.prologue();\n" + _PACK, _PACK + "    ring.prologue();\n")],
    # one part taken out (outputs wrong on purpose)
    "no_tag_test": [(_VIOL, "    uint32_t viol = 0;")],
    "no_cells_out": [(_FINISH, "    if (a.T < 0) a.valid[threadIdx.x] = viol "
                      "+ in.wm + in.warm[0] + in.strat + in.conc;")],
    "no_occ_pack": [(_PACK + "    const Workers v",
                     "    const Workers v")],
    "no_key": [("    if (lane == 0)\n      red_min(",
                "    if (a.T < 0)\n      red_min(")],
    "no_ticket": [("    if (last_s) {", "    if (false) {")],
}


def variant_text(name: str) -> str:
    """The header with variant ``name``'s substitutions made; each must
    match the source."""
    text = (CSRC / "affinity_common.cuh").read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise ValueError(f"variant {name}: {old!r} is not in the source")
        text = text.replace(old, new)
    return text


def worker(name: str) -> dict:
    """Build and measure one variant in this process."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.affinity import (AFFINITY_VALID_KERNEL,
                                              BULK_DECIDE_KERNEL)
    from repro_torch.kernels.affinity.bulk_ref import bulk_decide_ref
    from repro_torch.kernels.affinity.ref import affinity_valid_ref
    from repro_torch.kernels.build import CudaKernel, build_all

    work = WORK / name
    work.mkdir(parents=True, exist_ok=True)
    (work / "affinity_common.cuh").write_text(variant_text(name))
    kernels = {}
    for k0 in (AFFINITY_VALID_KERNEL, BULK_DECIDE_KERNEL):
        shutil.copy(k0.source, work / k0.source.name)
        k = CudaKernel(f"{k0.name}_{name}", str(work / k0.source.name),
                       entry=k0.entry, argtypes=k0.argtypes,
                       headers=(str(work / "affinity_common.cuh"),),
                       flags=k0.flags)
        k.library_path().unlink(missing_ok=True)
        kernels[k0.name] = k
    out = {"variant": name, "build_s": build_all(list(kernels.values())),
           **{n: cs.ptxas_summary(k.build_log) for n, k in kernels.items()}}

    exact = True
    for W, T, R in cs.AFFINITY_CASES:
        ins, extra = cs.on_card(cs.kernel_case(W, T, R, seed=W + T + R))
        _, (valid,) = cs.affinity_entry(kernels["affinity_valid"], ins)
        _, got = cs.affinity_entry(kernels["bulk_decide"], ins, extra)
        torch.cuda.synchronize()
        want = bulk_decide_ref(*ins, *extra)
        exact &= torch.equal(valid, affinity_valid_ref(*ins))
        exact &= all(torch.equal(g.view(torch.int32) if g.is_floating_point()
                                 else g, w.view(torch.int32)
                                 if w.is_floating_point() else w)
                     for g, w in zip(got, want))
    out["bit_exact"] = exact
    for label, (W, T, R) in (("main", (16384, 4, 6)),
                             ("T512", (16384, 512, 512))):
        case = cs.kernel_case(W, T, R, seed=5)
        ins, extra = cs.on_card(case)
        f_ins, _ = cs.on_card(cs.first_rows(case, 2))
        for n, call in (
                ("affinity_valid",
                 cs.affinity_entry(kernels["affinity_valid"], f_ins)[0]),
                ("bulk_decide",
                 cs.affinity_entry(kernels["bulk_decide"], ins, extra)[0])):
            out[f"{n}_{label}_ms"] = cs.cuda_ms(call)
            out[f"{n}_{label}_device_ms"] = cs.device_ms(call)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", default=list(VARIANTS))
    ap.add_argument("--out", type=Path, default=None,
                    help="also append each JSON line to this file")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.names[0])), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("affinity_variants: needs an NVIDIA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    failed = 0
    for name in args.names:
        r = subprocess.run([sys.executable, __file__, "--worker", name],
                           capture_output=True, text=True)
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
        if r.returncode or not lines:
            failed += 1
            print(json.dumps({"variant": name, "failed": r.returncode,
                              "stderr": r.stderr[-2000:]}), flush=True)
            continue
        print(lines[-1], flush=True)
        if args.out:
            with args.out.open("a") as f:
                f.write(lines[-1] + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
