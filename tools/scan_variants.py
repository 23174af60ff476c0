#!/usr/bin/env python3
"""Time variants of the selective-scan kernel on one NVIDIA card.

    python3 tools/scan_variants.py [--out FILE] [NAME ...]

Each variant is ``src/repro_torch/kernels/mamba_scan/csrc/selective_scan.cu``
with a few text substitutions (``VARIANTS``): another K at N = 16, ``expf``
for the exponent, the other lane mapping, or one part of the work taken out
to see what it costs (those give wrong outputs on purpose).  Each is built
with ``nvcc`` and run in a process of its own: a second library holding the
same kernel instances, loaded into one process, fails its first launch with
``cudaErrorInvalidValue``.  For each variant the script prints one JSON line:
its registers and spills, the largest error against the plain version on
``chip_smoke.SCAN_CASES``, on the long-memory case and at the serving shape
(relative to max(1, max |y|) for the last two), and its CUDA-event and
profiler device ms at the serving shape (1, 4096, 8192, 16), dt float32 and
x / b / c bf16.  The card's name and power limit come first.

Variants named ``fused*`` measure the second entry (the scan with the
block's softplus, D skip, gate and cast) instead: its largest error
against its plain version on ``chip_smoke.FUSED_CASES`` and at the serving
shape (relative to max(1, max |out|)), and its times at the serving shape
in bf16 with falcon-mamba-7b's views (z, B and C read in place).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/mamba_scan/csrc/selective_scan.cu"
WORK = ROOT / "build" / "scan_variants"

_K = "static constexpr int K = N < kMaxStatesPerThread ? N : " \
     "kMaxStatesPerThread;"


def _k16(k: int):
    return [(_K, f"static constexpr int K = N == 16 ? {k} : (N < "
                 "kMaxStatesPerThread ? N : kMaxStatesPerThread);")]


_SOFTPLUS = ("return v > 20.f ? v : log1pf(expf(v));",
             "return v > 20.f ? v : __logf(1.f + __expf(v));")
_SILU = ("return v / (1.f + expf(-v));",
         "return __fdividef(v, 1.f + __expf(-v));")

#: name -> substitutions (old, new) applied to the kernel's source
VARIANTS = {
    "kernel": [],
    "k2_at_n16": _k16(2),
    "k8_at_n16": _k16(8),
    "expf": [("exp2_approx(dx.x * a2[k])", "expf(dx.x * a2[k])"),
             ("* kLog2e : 0.f", ": 0.f")],
    "lanes_channel_major": [
        ("const int ch = (tid / 32) * Sh::kWarpCh + tid % Sh::kWarpCh;",
         "const int ch = tid / L;"),
        ("const int j = (tid % 32) / Sh::kWarpCh;",
         "const int j = tid % L;"),
        ("ReduceScatter<L / 2, kU, Sh::kWarpCh>",
         "ReduceScatter<L / 2, kU, 1>")],
    "three_stages": [("constexpr int kStages = 2;",
                      "constexpr int kStages = 3;")],
    # one part taken out (outputs wrong on purpose)
    "no_exp": [("const float abar = exp2_approx(dx.x * a2[k]);",
                "const float abar = dx.x * a2[k];")],
    "no_shuffles": [("ReduceScatter<L / 2, kU, Sh::kWarpCh>::run(p, j);", "")],
    "no_dt_x_widening_after_first_chunk": [
        ("    widen_dx<Sh::kThreads, kFused>(s_dx, st,",
         "    if (ci == 0) widen_dx<Sh::kThreads, kFused>(s_dx, st,")],
    "no_loads_after_first_chunk": [
        ("    if (cn < n_chunks)\n", "    if (cn < n_chunks && ci < 0)\n")],
    "no_steps": [("    float prev[kU];\n    steps(0, prev);",
                  "    float prev[kU] = {};"),
                 ("      steps(g, p);\n",
                  "      for (float& v : p) v = 0.f;\n")],
    # the second entry: its extra work through the MUFU's fast forms (less
    # accurate, so never the kernel's), or taken out
    "fused": [],
    "fused_fast_softplus": [_SOFTPLUS],
    "fused_fast_silu": [_SILU],
    "fused_fast_both": [_SOFTPLUS, _SILU],
    "fused_no_softplus": [(
        "d = make_float2(softplus(d.x + bias.x), softplus(d.y + bias.y));",
        "d = make_float2(d.x + bias.x, d.y + bias.y);")],
    "fused_no_gate": [("        if constexpr (kFused) v = gate(v, tt);\n",
                       "")],
    "fused_no_z": [("      if (es_x == 2)\n        stage_rows<T, 2>(s_z, fu.z, ",
                    "      if (false)\n        stage_rows<T, 2>(s_z, fu.z, "),
                   ("      else stage_rows<T, 4>(s_z, fu.z, ",
                    "      else if (false) stage_rows<T, 4>(s_z, fu.z, ")],
}


def variant_text(name: str) -> str:
    """The kernel's source with variant ``name``'s substitutions made; each
    must match the source."""
    text = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise ValueError(f"variant {name}: {old!r} is not in the source")
        text = text.replace(old, new)
    return text


def worker(name: str) -> dict:
    """Build and measure one variant in this process."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels.build import CudaKernel, build_all

    k0 = ms.SELECTIVE_SCAN_FUSED_KERNEL if name.startswith("fused") \
        else ms.SELECTIVE_SCAN_KERNEL
    WORK.mkdir(parents=True, exist_ok=True)
    source = WORK / f"selective_scan_{name}.cu"
    source.write_text(variant_text(name))
    k = CudaKernel(f"selective_scan_{name}", str(source),
                   entry=k0.entry, argtypes=k0.argtypes, flags=k0.flags)
    k.library_path().unlink(missing_ok=True)
    out = {"variant": name, "build_s": build_all([k]),
           **cs.ptxas_summary(k.build_log)}
    if name.startswith("fused"):
        return {**out, **fused_worker(k)}

    def err(ins, relative=False):
        _, y = cs.scan_entry(k, *ins)
        want = ms.selective_scan_ref(*ins)
        e = cs.max_abs_err(y, want)
        return e / max(1.0, float(want.abs().max())) if relative else e

    out["cases_max_abs_err"] = max(
        err(cs.scan_inputs(B, S, D, N, dt, seed=100 + i))
        for i, (B, S, D, N, dt) in enumerate(cs.SCAN_CASES))
    out["long_memory_rel_err"] = err(cs.scan_long_inputs(99), True)
    ins = cs.scan_serving_inputs(14)
    out["serving_rel_err"] = err(ins, True)
    call, _ = cs.scan_entry(k, *ins)
    out["ms"] = cs.cuda_ms(call, iters=30, warmup=5)
    out["device_ms"] = cs.device_ms(call, iters=20)
    return out


def fused_worker(k) -> dict:
    """The second entry of variant library ``k``: errors and times."""
    import chip_smoke as cs
    from repro_torch.kernels import mamba_scan as ms

    def err(ins):
        _, got = cs.fused_entry(k, *ins)
        want = ms.selective_scan_fused_ref(*ins)
        return cs.max_abs_err(got, want) / max(1.0, float(want.abs().max()))

    out = {"cases_max_rel_err": max(
        err(cs.fused_inputs(*case, seed=100 + i))
        for i, case in enumerate(cs.FUSED_CASES) if case[1] * case[2] < 1e6)}
    falcon = cs.FALCON_MAMBA_7B
    ins = cs.fused_inputs(1, cs.PROMPT, 2 * falcon.d_model,
                          falcon.ssm.d_state, "bfloat16",
                          falcon.ssm.resolved_dt_rank(falcon.d_model), 14)
    out["serving_rel_err"] = err(ins)
    call, _ = cs.fused_entry(k, *ins)
    out["ms"] = cs.cuda_ms(call, iters=30, warmup=5)
    out["device_ms"] = cs.device_ms(call, iters=20)
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
        print("scan_variants: needs an NVIDIA card", file=sys.stderr)
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
