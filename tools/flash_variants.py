#!/usr/bin/env python3
"""Time variants of the bf16 flash-attention kernel on one NVIDIA card.

    python3 tools/flash_variants.py [--earlier FILE] [--shapes NAME ...]
                                    [--out FILE] [NAME ...]

Each variant is ``src/repro_torch/kernels/flash_attention/csrc/
flash_attention_sm90.cu`` with a few text substitutions (``VARIANTS``):
other tiles or stages for one head dim, no turns between the consumers,
another launch order, or one part of the work taken out to see what it
costs (those give wrong outputs on purpose).
The ``earlier*`` variants are the same substitutions on an earlier source
given with ``--earlier`` (the design of commit 27c0744: BQ = 128, BK = 64,
2 stages, S, softmax and P V in turn, for every head dim), e.g. from ``git
show 27c0744:src/repro_torch/kernels/flash_attention/csrc/
flash_attention_sm90.cu``.  Each is built with ``nvcc`` and run in a
process of its own: a second library holding the same kernel instances,
loaded into one process, fails its first launch.  For each variant the
script prints one JSON line: its registers and spills, its largest error
over the per-element tolerance of ``chip_smoke.flash_bf16_bound`` on the
bf16 ``chip_smoke.FLASH_CASES`` and at each timed shape, and its CUDA-event
and profiler device ms through the bare entry point at the serving shapes
(``SHAPES``).  The card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = (ROOT / "src/repro_torch/kernels/flash_attention/csrc/"
          "flash_attention_sm90.cu")
WORK = ROOT / "build" / "flash_variants"
#: seconds a variant's process may take (build and every shape)
TIMEOUT_S = 300

#: (B, S, H, K, hd, causal, window) of the main path's bf16 calls
SHAPES = {
    "qwen3-moe-30b-a3b": (1, 4096, 32, 4, 64, True, None),
    "seamless-noncausal": (1, 2048, 16, 16, 64, False, None),
    "seamless-causal": (1, 2048, 16, 16, 64, True, None),
    "jamba-1.5-large-398b": (1, 4096, 64, 8, 128, True, None),
    "arctic-480b": (1, 4096, 56, 8, 128, True, None),
    "gemma3-4b": (1, 4096, 8, 4, 256, True, None),
    "gemma3-4b-window1024": (1, 4096, 8, 4, 256, True, 1024),
}


def _tiles(hd: int, tiles: str):
    """Instance ``hd``'s TilesOf<...> arguments, as the source has them,
    replaced by ``tiles``."""
    old = re.search(rf"struct Tiles<{hd}> : TilesOf<[^>]*>",
                    SOURCE.read_text()).group(0)
    return [(old, f"struct Tiles<{hd}> : TilesOf<{tiles}>")]


NO_EXP2 = ("s[x] = exp2f(s[x] - m[r]);", "s[x] = s[x] - m[r];")
NO_PV = ("wgmma_rs<HD>(acc, pa[kk], db);", "(void)db;")
NO_MASK = ("  if (edge) {", "  if (false) {")
NO_S = ("wgmma_ss<T::BK>(s, da, db, kk > 0);", "(void)da, (void)db;")
MAX4 = ("""  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int x = 0; x < N; ++x) {
    const int r = (x >> 1) & 1;
    mx[r] = fmaxf(mx[r], s[x]);
  }
""", """  float mq[2][4] = {{m[0], m[0], m[0], m[0]}, {m[1], m[1], m[1], m[1]}};
#pragma unroll
  for (int x = 0; x < N; ++x) {
    const int r = (x >> 1) & 1;
    mq[r][(x >> 2) & 3] = fmaxf(mq[r][(x >> 2) & 3], s[x]);
  }
  float mx[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    mx[r] = fmaxf(fmaxf(mq[r][0], mq[r][1]), fmaxf(mq[r][2], mq[r][3]));
""")
EXP2_FTZ = ("    s[x] = exp2f(s[x] - m[r]);",
            "    asm(\"ex2.approx.ftz.f32 %0, %1;\" : \"=f\"(s[x]) : "
            "\"f\"(s[x] - m[r]));")
# the producer arrives on the full barriers without copying k and v (the
# consumers compute on whatever the stages hold)
NO_COPIES = [
    ("        mbar_expect_tx(g.k_full + 8 * st, L::kv_bytes);\n"
     "#pragma unroll\n"
     "        for (int c = 0; c < NS; ++c)\n"
     "          tma_load_4d(kbuf + c * BK * 128, &tm_k, g.k_full + 8 * st,\n"
     "                      c * kSlab, kh, kt * BK, b);\n",
     "        mbar_arrive(g.k_full + 8 * st);\n"),
    ("        mbar_expect_tx(g.v_full + 8 * st, L::kv_bytes);\n"
     "#pragma unroll\n"
     "        for (int c = 0; c < NS; ++c)\n"
     "          tma_load_4d(vbuf + c * BK * 128, &tm_v, g.v_full + 8 * st,\n"
     "                      c * kSlab, kh, kt * BK, b);\n",
     "        mbar_arrive(g.v_full + 8 * st);\n")]
NO_SOFTMAX = ("    softmax<T, MASK>(s, m, l, alpha, (w.kt_begin + i) * T::BK, w);",
              "    alpha[0] = alpha[1] = 1.f;")

#: name -> substitutions (old, new) applied to the source; names starting
#: with "earlier" apply to the --earlier source
VARIANTS = {
    "kernel": [],
    # no turns between the consumers: the named barriers taken out
    "no_pingpong": [
        ('  asm volatile("bar.sync %0, 256;\\n" ::"r"(id) : "memory");\n',
         "  (void)id;\n"),
        ('      "@p bar.arrive %0, 256;\\n}\\n" ::"r"(id),\n',
         '      "}\\n" ::"r"(id),\n')],
    # hd 64 on three consumers of 160 registers (192 query rows a CTA)
    "hd64_bq192": _tiles(64, "192, 128, 3, 3, 32, 160"),
    "hd64_2stages": _tiles(64, "128, 128, 2, 2, 24, 240"),
    "hd64_4stages": _tiles(64, "128, 128, 4, 2, 24, 240"),
    "hd128_3stages": _tiles(128, "128, 128, 3, 2, 24, 240"),
    "hd64_bk64": _tiles(64, "128, 64, 3, 2, 24, 240"),
    "hd128_bk64": _tiles(128, "128, 64, 3, 2, 24, 240"),
    # the earlier launch order: the query tiles of one head together
    "qt_fastest": [("  const int qt = nq - 1 - cta / hb;\n"
                    "  const int h = cta % hb % H;\n"
                    "  const int b = cta % hb / H;\n",
                    "  const int qt = nq - 1 - cta % nq;\n"
                    "  const int h = cta / nq % H;\n"
                    "  const int b = cta / nq / H;\n")],
    # the turn passed once S is done, not once it is issued
    "pass_after_s": [(
        "  turn_pass(1 + (cw + 1) % C, i < w.n || cw < C - 1);\n"
        "  if constexpr (DO_S) {\n"
        "    wgmma_wait<DO_PV ? 1 : 0>();  // S of this tile; P V runs on\n"
        "    fence_regs(s);\n"
        "  }\n",
        "  if constexpr (DO_S) {\n"
        "    wgmma_wait<DO_PV ? 1 : 0>();  // S of this tile; P V runs on\n"
        "    fence_regs(s);\n"
        "  }\n"
        "  turn_pass(1 + (cw + 1) % C, i < w.n || cw < C - 1);\n")],
    # the k stage released after the softmax by an arrival that reads l,
    # which keeps the exp2s ahead of the wait for P V in the SASS
    "exp2_before_pv_wait": [(
        "  release(g.k_empty + 8 * st, w.lane, i < w.n);\n"
        "  float alpha[2];\n"
        "  if constexpr (DO_S)\n"
        "    softmax<T, MASK>(s, m, l, alpha, (w.kt_begin + i) * T::BK, w);\n",
        "  float alpha[2];\n"
        "  bool k_done = i < w.n;\n"
        "  if constexpr (DO_S) {\n"
        "    softmax<T, MASK>(s, m, l, alpha, (w.kt_begin + i) * T::BK, w);\n"
        "    k_done = k_done && !(l[0] + l[1] < 0.f);\n"
        "  }\n"
        "  release(g.k_empty + 8 * st, w.lane, k_done);\n")],
    # the row max in four partial maxima a row (the same result)
    "max4": [MAX4],
    # exp2 without the subnormal range (ex2.approx.ftz)
    "exp2_ftz": [EXP2_FTZ],
    "max4_exp2_ftz": [MAX4, EXP2_FTZ],
    # one part taken out (outputs wrong on purpose)
    "no_exp2": [NO_EXP2],
    "no_pv": [NO_PV],
    "no_s": [NO_S],
    "no_softmax": [NO_SOFTMAX],
    "copies_only": [NO_S, NO_PV, NO_SOFTMAX],
    "no_copies": NO_COPIES,
    "earlier": [],
    "earlier_no_exp2": [NO_EXP2],
    "earlier_no_pv": [NO_PV],
    "earlier_no_mask": [NO_MASK],
}


def variant_text(name: str, earlier: Path = None) -> str:
    """The source with variant ``name``'s substitutions made; each must
    match the source."""
    if name.startswith("earlier"):
        if earlier is None:
            raise ValueError(f"variant {name} needs --earlier")
        text = earlier.read_text()
    else:
        text = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise ValueError(f"variant {name}: {old!r} is not in the source")
        text = text.replace(old, new)
    return text


def worker(name: str, earlier: Path, shapes) -> dict:
    """Build and measure one variant in this process."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.build import CudaKernel, build_all

    k0 = fa.FLASH_ATTENTION_BF16_KERNEL
    WORK.mkdir(parents=True, exist_ok=True)
    source = WORK / f"flash_attention_sm90_{name}.cu"
    source.write_text(variant_text(name, earlier))
    k = CudaKernel(f"flash_attention_bf16_{name}", str(source),
                   entry=k0.entry, argtypes=k0.argtypes, flags=k0.flags)
    k.library_path().unlink(missing_ok=True)
    out = {"variant": name, "build_s": build_all([k]),
           **cs.ptxas_summary(k.build_log)}

    def err(q, kk, v, causal, window):
        _, o = cs.flash_entry(k, q, kk, v, causal, window)
        want, tol = cs.flash_bf16_bound(q, kk, v, causal, window)
        d = (o.float() - want).abs()
        return (float((d / tol).nan_to_num(nan=0.0, posinf=1e30).max()),
                float(d.max()))

    out["cases_err_over_tol"] = max(
        err(*cs.flash_inputs(B, Sq, Skv, H, K, hd, torch.bfloat16, seed=i),
            causal, window)[0]
        for i, (B, Sq, Skv, H, K, hd, causal, window)
        in enumerate(cs.FLASH_CASES))
    for label in shapes:
        B, S, H, K, hd, causal, window = SHAPES[label]
        q, kk, v = cs.flash_inputs(B, S, S, H, K, hd, torch.bfloat16,
                                   seed=len(label))
        e, e_abs = err(q, kk, v, causal, window)
        call, _ = cs.flash_entry(k, q, kk, v, causal, window)
        out[label] = {"err_over_tol": e, "max_abs_err": e_abs,
                      "ms": cs.cuda_ms(call, iters=50, warmup=5),
                      "device_ms": cs.device_ms(call, iters=20)}
        del q, kk, v
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*",
                    help="variants to run (default: all; the earlier* ones "
                    "only with --earlier)")
    ap.add_argument("--earlier", type=Path, default=None,
                    help="an earlier flash_attention_sm90.cu for the "
                    "earlier* variants")
    ap.add_argument("--shapes", nargs="+", default=list(SHAPES),
                    choices=list(SHAPES))
    ap.add_argument("--out", type=Path, default=None,
                    help="also append each JSON line to this file")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    earlier = args.earlier.resolve() if args.earlier else None
    args.names = args.names or [n for n in VARIANTS
                                if earlier or not n.startswith("earlier")]
    if args.worker:
        print(json.dumps(worker(args.names[0], earlier, args.shapes)),
              flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("flash_variants: needs an NVIDIA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    failed = 0
    for name in args.names:
        cmd = [sys.executable, __file__, "--worker", name, "--shapes",
               *args.shapes]
        if earlier is not None:
            cmd += ["--earlier", str(earlier)]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            failed += 1
            print(json.dumps({"variant": name, "failed": "timeout"}),
                  flush=True)
            continue
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
