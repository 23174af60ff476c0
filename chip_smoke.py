#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--baseline-scan PATH] [--baseline-affinity DIR]

Phases, one line each (every time beside the card's name and power limit):

1. card   — ``nvidia-smi`` name and power limit; fails without CUDA;
2. build  — the five kernels from ``src/repro_torch/kernels/*/csrc/*.cu``
   with ``nvcc``, one process per source, in parallel;
3. kernels vs plain — each affinity kernel against its plain PyTorch version
   on the card, bit for bit, at the edges of its geometry
   (``AFFINITY_CASES``) and at the main path's shapes, with rows that are
   all tied (the lowest index must win) and rows with no valid worker
   (``-1``); the float32 flash-attention kernel against
   its plain version within 2e-5 and the bf16 one against the plain
   version on its inputs widened to float32, element by element within the
   bound of its two roundings, on the whole inputs and on v restricted to a
   late key tile, each with a dropped key tile shown to exceed 4x that
   bound, at ragged lengths, Sq != Skv, GQA ratios 1, 2, 4, head dims 64,
   128, 256, window 1 and a window past the sequence, causal with a window
   at Sq != Skv; the selective-scan kernel against its plain version within
   1e-4 at the shapes of ``tests/test_kernels.py``'s sweep and around its
   tiling (S below and across 64-step chunks, D off its 32-channel tile
   and off a multiple of 8, every N, float32 and bfloat16 inputs), and on
   a long memory (a = -0.01 exp(normal), S = 2085) within 1e-4
   max(1, max |y|), where the plain version with the state reset at a
   chunk boundary must miss by 100x that;
4. decision path — the port's ``Platform`` on the reference scheduler-scale rig
   (16384 workers of 64 MB, 50% pre-occupied, 5% sparse warm residency):
   512 ``decide()`` calls, ``decide_batch`` waves of 512 with
   ``apply=False``, one ``apply=True`` wave.  The decisions must equal the
   same run on the float64 ``backend="np"`` twin, and both kernels' launch
   counters must have moved.  Then each kernel against its plain version
   on the card, bit for bit, on the inputs the main path gives it (every
   function's per-arrival rows, a wave's rows) from the live session;
5. times — each affinity kernel's CUDA-event time at the main path's shapes
   and at the 512-tag, 512-row scale, its profiler device time split by
   kernel name (a call must be one launch), its plain version's times, and
   its bound; where a call's time goes at the main path's shapes (the bare
   ctypes entry, the checked kernel wrapper and the package entry, by events
   and by host enqueue time); with ``--baseline-affinity DIR`` the parent
   commit's two kernels built and timed beside them, in turns, at all four
   shapes; end-to-end us/decision per arrival and
   per wave of 512, beside the float64 host twin's on the same host, and
   the per-arrival valid call with two of its parts (inputs to the card,
   the result back to the host);
6. serving path — gemma3-4b whole (34 layers, bf16, weights drawn on the card
   from a seeded generator) behind the port's ``serve.Engine`` on
   ``two_pod_cells()``: 4 sessions' prefills of 4096 seeded tokens through
   the bf16 flash kernel, 32 decodes, one cell failed mid-run (its sessions
   are re-prefilled elsewhere).  Every completion must be ok, every decode
   on its session's cell, every logit finite; the bf16 flash counter must
   move by exactly 34 per prefill, the float32 one not at all, and
   ``affinity_valid``'s must move.  Then the bf16 flash kernel against the
   plain version on the q / k / v of the first local and the first global
   layer, captured from the live prefill (its bound and dropped-tile
   control as in phase 3), and the float32 kernel on them widened;
7. whole model in float32 — one local:global period of gemma3-4b at full
   width (6 layers), S = 2048: prefill logits through the float32 flash
   kernel (6 launches, none of the bf16 one) against the direct path;
8. serving times — both flash kernels at (1, 4096, 8, 4, 256) in their
   types, causal and window 1024 (CUDA-event and profiler ms, plain ms,
   ``scaled_dot_product_attention`` ms, bound); prefill ms and tokens/s,
   decode ms per token and the engine's scheduling us per request; where
   one prefill's and one decode step's time goes on the card (profiler:
   flash, matrix products, the rest, and the device's idle share);
9. SSM serving path — gemma3-4b's weights freed, falcon-mamba-7b whole (64
   mamba layers, d_inner 8192, N = 16, bf16, weights drawn on the card)
   behind the same engine, deployment, sessions, decodes and cell failure
   as phase 6: every completion ok, every decode on its session's cell,
   every logit finite, the selective-scan counter moved by exactly 64 per
   prefill and the flash counters not at all.  Then the scan kernel against
   its plain version on the dt / x / b / c / a of the first layer of the
   first live prefill, within 1e-4 max(1, max |y|);
10. SSM model in float32 — falcon-mamba-7b at full width with 2 layers,
   S = 2048: the prefill's logits at every position through the kernel
   against ``backend="ref"`` on the card, within 1e-4 max(1, max |logit|);
11. SSM times — the scan kernel at (1, 4096, 8192, 16) with the serving
   path's types (dt float32, x / b / c bf16): CUDA-event and profiler ms,
   plain ms, the bound and its share of the device time, the MUFU floor,
   the kernel's registers, and where a call's time goes (the bare ctypes
   entry, the checked kernel wrapper and the package entry, back to back,
   by events and by host enqueue time); with ``--baseline-scan PATH`` an
   earlier ``selective_scan.cu`` built and timed beside it, in turns, on
   the same inputs; falcon-mamba-7b's prefill ms and tokens/s,
   decode ms per token, scheduling us per request, and where one prefill's
   and one decode step's time goes (scan kernel, matrix products, the
   rest, idle share);
12. trace path — ``TraceWorkload`` on the port's ``ClusterSim``: the paper
   testbed replicated 2731 times (16,386 workers, two zones) behind a
   ``fixed_ttl`` warm pool.  Run A: the ``poisson`` scenario at 4 arrivals/s
   a replica, over the shortest window holding 4096 arrivals, decided one
   arrival at a time through ``affinity_valid`` with the obs plane (tracer,
   stage timers) and an active resilience bundle with retry attached, the
   ``us`` zone killed and healed mid-window by the chaos harness; its
   records, rng tail and decision log must equal the ``device="cpu"``
   run's, its records and rng tail the float64 ``backend="np"`` run's, its
   Chrome trace must validate, work must be conserved per worker, and
   every lost activation must be retried or counted lost; one slice of it
   runs again under the profiler for the device's idle share.  Run B: 64
   ticks of 512 same-tick arrivals through the wave batcher, untraced, one
   ``bulk_decide`` launch a wave; its records must equal the same trace
   decided one arrival at a time on the card, the ``device="cpu"`` run's
   and the float64 twin's;

then a ``{"kernels": [...]}`` line, the card line, and the result line
``{"ok": true, "device": {...}}``.  Any failed phase raises: the script
exits non-zero and prints no result line.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import gc
import json
import math
import random
import re
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.cluster.simulator import (ClusterSim,  # noqa: E402
                                           SimParams)
from repro_torch.cluster.topology import (WorkerSpec,  # noqa: E402
                                          paper_testbed, two_pod_cells)
from repro_torch.configs.registry import (FALCON_MAMBA_7B,  # noqa: E402
                                          GEMMA3_4B)
from repro_torch.core.ast import (AAppScript, Affinity, Block,  # noqa: E402
                                  Invalidate, TagPolicy)
from repro_torch.core.state import ClusterState, Registry  # noqa: E402
from repro_torch.kernels.affinity import (  # noqa: E402
    AFFINITY_VALID_KERNEL, BULK_DECIDE_KERNEL, KERNELS, NO_CAP, NO_CONC,
    affinity_valid, affinity_valid_np, bulk_decide)
from repro_torch.kernels.affinity import bulk_kernel  # noqa: E402
from repro_torch.kernels.affinity import kernel as affinity_kernel  # noqa: E402
from repro_torch.kernels.affinity.bulk_ref import bulk_decide_ref  # noqa: E402
from repro_torch.kernels.affinity.ops import as_inputs  # noqa: E402
from repro_torch.kernels.affinity.ref import affinity_valid_ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.kernels.build import build_all  # noqa: E402
from repro_torch.models import (init_cache, init_model,  # noqa: E402
                                model_decode_step, model_forward)
from repro_torch.models.transformer import lm_logits  # noqa: E402
from repro_torch.obs import Obs, validate_chrome_trace  # noqa: E402
from repro_torch.platform import Platform  # noqa: E402
from repro_torch.pool import StartCosts, WarmPool, make_policy  # noqa: E402
from repro_torch.resilience import (HEAL_ZONE, KILL_ZONE,  # noqa: E402
                                    ChaosHarness, Fault, Resilience,
                                    RetryPolicy)
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from repro_torch.train.step import make_prefill_step  # noqa: E402
from repro_torch.workload import (COMPUTE_S, FUNCTION_MIX,  # noqa: E402
                                  Arrival, ReplayConfig, RunResult,
                                  TraceWorkload, build_trace,
                                  register_functions)
from repro_torch.workload.replay import (build_script,  # noqa: E402
                                         chrome_trace)

# H100 SXM peaks (NVIDIA data sheet, dense, at the full 700 W limit)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12  # the CUDA cores, outside the tensor cores

# the reference rig (benchmarks/scheduler_scale.py): cluster, occupancy,
# residency, wave size and seeds
WORKERS = 16384
MAX_MEMORY = 64.0
OCCUPANCY = 0.5
WARM_FRAC = 0.05
WAVE = 512
N_WAVES = 4
FUNCTIONS = {"f_lat": (1.0, "lat"), "f_train": (8.0, "train"),
             "f_batch": (2.0, "batch")}

# phase 3's affinity shapes (W, T, R): the edges of the kernels' geometry
# (csrc/affinity_common.cuh: 128-worker tiles, 4 workers a thread, 512 rows a
# block, 32-tag words in register chunks of up to 8, and the three occ load
# paths: T a multiple of 32, T <= 32, any other T), W = 1, 3, 5, 16385,
# T = 1, 31, 32, 33, 513, R one past a block's rows, and the main path's
# and the 512-tag scale's shapes
AFFINITY_CASES = [(1, 1, 1), (3, 31, 2), (5, 32, 513), (130, 5, 257),
                  (16385, 3, 129), (16385, 33, 7), (1, 513, 4),
                  (257, 512, 1025), (4100, 96, 600), (16384, 1, 6),
                  (16384, 4, 3), (16384, 512, 512)]

# the TPU kernel each CUDA kernel replaces (its Pallas body in the JAX package)
REPLACES = {"affinity_valid": "src/repro/kernels/affinity/kernel.py:33",
            "bulk_decide": "src/repro/kernels/affinity/bulk_kernel.py:31",
            "flash_attention":
                "src/repro/kernels/flash_attention/kernel.py:27",
            "flash_attention_bf16":
                "src/repro/kernels/flash_attention/kernel.py:27",
            "selective_scan": "src/repro/kernels/mamba_scan/kernel.py:25"}
ALL_KERNELS = (*KERNELS, *fa.KERNELS, *ms.KERNELS)

# the serving path (launch/serve.py's deployment, gemma3-4b at full size)
PROMPT = 4096
SESSIONS = 4
DECODES = 32
FAIL_AT = 16  # the decode before which session s0's cell fails
MAX_LEN = PROMPT + 64
DEPLOY = ["pod0-cell0", "pod0-cell1", "pod1-cell0"]
# flash kernels vs plain.  float32: tests/test_kernels.py's 2e-5 against the
# plain version on the same inputs.  bfloat16: against the plain version on
# the same inputs widened to float32, element by element, within the bound
# of the kernel's two roundings.  bf16 keeps 8 significant bits, so rounding
# to nearest moves a value by at most 2^-9 of it: p rounded before the
# product with v moves o_i = sum(p v_i) / sum(p) by at most
# 2^-9 sum(p |v_i|) / sum(p), the plain version on |v|; o rounded at the end
# moves o_i by at most 2^-9 |o_i|.  Both are doubled, and the first twice
# more, for float32 sums in another order, the float32 error of s (which
# moves p by much less than 2^-9 at these shapes) and the one rounding of
# q / sqrt(hd) to bf16 that the JAX package's chunked path makes at
# hd = 128:
#     tol_i = 2^-8 (|o_i| + 2 attn(|v|)_i)      (flash_bf16_bound)
# Each check has a control that shows it can see a wrong tile: the plain
# version with the v rows of one 64-key tile zeroed must move some element,
# in a row that sees the whole tile, by at least FLASH_DROP x its tolerance
# (flash_bf16_check).  On the whole inputs the tile dropped is the first,
# or under a window the one most rows see (dropped_tile).  A row that sees
# thousands of keys moves by one tile's share when a tile goes, while its
# bound counts the rounding of every key, so the loss of a late tile shows
# by only a few times the bound; a second check holds the kernel on v with
# every key tile but a late one zeroed (late_tile: the one before the last
# row's diagonal, which only late rows see).  The output is then that
# tile's share alone, bounded by that tile's roundings alone, and dropping
# the tile leaves zeros where the rows that see all of it (4000 keys and
# more at the serving shape) had their share.
FLASH_TOL = {torch.float32: 2e-5}
BF16_ROUNDING = 2.0 ** -8
FLASH_DROP = 4.0
FLASH_TILE = 64
# what phase 3 prints of each bf16 check (flash_bf16_check)
BF16_KEYS = ("tile", "max_abs_err", "err_over_tol", "drop_over_tol")
# the float32 whole-model check's bound on logits
MODEL_F32_TOL = 1e-2
F32_PROMPT = 2048
# selective scan vs plain: tests/test_kernels.py's 1e-4 (the sum over N is
# taken in another order, so the two are not bit-identical); on the serving
# path's inputs and on the float32 model's logits, 1e-4 of the larger of 1
# and the largest |output|
SCAN_TOL = 1e-4
SSM_F32_LAYERS = 2


def smoke_script() -> AAppScript:
    """``SCRIPT_TMPL`` of the scheduler-scale rig, built from the port's AST
    classes (no YAML parser needed)."""
    return AAppScript(policies=(
        TagPolicy(tag="lat", blocks=(Block(
            workers=("*",), strategy="best_first",
            affinity=Affinity(anti_affine=("train", "lat_conflict"))),)),
        TagPolicy(tag="train", blocks=(Block(
            workers=("*",), strategy="best_first",
            invalidate=Invalidate(capacity_used=80.0),
            affinity=Affinity(anti_affine=("lat",))),)),
        TagPolicy(tag="batch", blocks=(Block(
            workers=("*",), strategy="best_first"),)),
    ))


Container = collections.namedtuple("Container", "cid")


class SparseResidency:
    """The rig's synthetic warm-pool residency: the ``warmth`` /
    ``warmth_row`` views of a warm pool over a fixed sparse table (~5% of
    (function, worker) pairs warm or hot).  ``acquire`` reports the start
    kind the table implies and changes nothing, so an applied wave leaves
    the residency as it found it."""

    KINDS = ("cold", "warm", "hot")

    def __init__(self, functions, workers, frac: float, seed: int):
        rng = random.Random(seed)
        self.rows = {}
        for f in functions:
            row = {w: rng.choice((1, 2)) for w in workers
                   if rng.random() < frac}
            if row:
                self.rows[f] = row
        self._n = 0

    def warmth(self, function: str, worker: str, now: float = 0.0) -> int:
        return self.rows.get(function, {}).get(worker, 0)

    def warmth_row(self, function: str, now: float):
        return self.rows.get(function, {})

    def acquire(self, function, worker, now, *, memory=None, tag=None):
        self._n += 1
        return (Container(f"c{self._n}"),
                self.KINDS[self.warmth(function, worker)], 0.0)

    def release(self, cid, now):
        return None


def build_rig(W: int, **platform_kw) -> Platform:
    """The rig's cluster (``_setup`` with seed 1) behind a port Platform."""
    st = ClusterState()
    reg = Registry()
    rng = random.Random(1)
    for i in range(W):
        st.add_worker(f"w{i}", max_memory=MAX_MEMORY)
    for f, (mem, tag) in FUNCTIONS.items():
        reg.register(f, memory=mem, tag=tag)
    for _ in range(int(W * OCCUPANCY)):  # pre-occupy (allocate does not
        w = f"w{rng.randrange(W)}"        # check memory: some overflow)
        st.allocate(rng.choice(["f_train", "f_batch"]), w, reg)
    pool = SparseResidency(tuple(FUNCTIONS), tuple(st.workers()), WARM_FRAC,
                           seed=4)
    return Platform(smoke_script(), cluster=st, registry=reg, pool=pool,
                    **platform_kw)


def drive_main_path(plat: Platform):
    """The main path once: per-arrival decisions, scratch waves, one applied
    wave.  Returns the decisions, the rng's next draw (the draw sequence
    must match too) and the host seconds of each part.  The requests are
    drawn from one seeded generator, so every wave mixes all three
    functions (the reference rig re-seeds per item and so sends one)."""
    mix = random.Random(2)
    fs = [mix.choice(sorted(FUNCTIONS)) for _ in range(WAVE * N_WAVES)]
    rng = random.Random(3)
    t0 = time.perf_counter()
    arrivals = [plat.decide(f, rng=rng).worker for f in fs[:WAVE]]
    t1 = time.perf_counter()
    waves = []
    for i in range(N_WAVES):
        waves.append([d.worker for d in plat.decide_batch(
            fs[i * WAVE:(i + 1) * WAVE], rng=rng, apply=False)])
    t2 = time.perf_counter()
    applied = [(d.worker, d.activation_id, d.start_kind) for d in
               plat.decide_batch(fs[:WAVE], rng=rng, apply=True)]
    t3 = time.perf_counter()
    return ({"arrivals": arrivals, "waves": waves, "applied": applied,
             "next_draw": rng.random()},
            {"arrival_s": t1 - t0, "wave_s": (t2 - t1) / N_WAVES,
             "applied_wave_s": t3 - t2})


# --------------------------------------------------------------------------- #
# kernel cases
# --------------------------------------------------------------------------- #


def kernel_case(W: int, T: int, R: int, seed: int):
    """Seeded inputs on the 0.25 grid, with the special rows every shape
    must get right: row 0 all tied (no affinity, no rules, one strategy,
    no warmth: every worker valid with one score — the lowest index wins)
    and row 1 with no valid worker (-1)."""
    rng = np.random.default_rng(seed)
    occ = rng.integers(0, 3, (W, T)).astype(np.int32)
    aff = rng.integers(-1, 2, (R, T)).astype(np.int8)
    aff[rng.random((R, T)) < 0.9] = 0  # mostly unconstrained: rows stay live
    wmask = rng.random((R, W)) > 0.2
    mem_used = (rng.integers(0, 200, W) * 0.25).astype(np.float32)
    max_mem = np.full(W, 64.0, np.float32)
    n_funcs = occ.sum(1).astype(np.int32)
    f_mem = (rng.integers(1, 64, R) * 0.25).astype(np.float32)
    cap = np.where(rng.random(R) > 0.5, 75.0, NO_CAP).astype(np.float32)
    conc = np.where(rng.random(R) > 0.5, 3, NO_CONC).astype(np.int32)
    strat = rng.integers(0, 4, R).astype(np.int32)
    warm = rng.integers(0, 3, (R, W)).astype(np.int32)
    mem_used[:] = np.minimum(mem_used, 40.0)
    aff[0], wmask[0], f_mem[0], cap[0], conc[0], strat[0] = \
        0, True, 0.25, NO_CAP, NO_CONC, 0
    warm[0] = 0
    if R > 1:
        wmask[1] = False
    return (occ, aff, wmask, mem_used, max_mem, n_funcs, f_mem, cap, conc,
            strat, warm)


def first_rows(case, n: int):
    """The validity inputs of a case cut to its first ``n`` rows (a
    per-arrival shape out of a wave's)."""
    occ, aff, wmask, mem, maxm, nfn, f_mem, cap, conc = case[:9]
    return (occ, aff[:n], wmask[:n], mem, maxm, nfn, f_mem[:n], cap[:n],
            conc[:n])


def on_card(case):
    """Validity inputs (and, for an 11-tuple, strat and warm) as card
    tensors."""
    dev = torch.device("cuda")
    ins = as_inputs(*case[:9], dev)
    return ins, tuple(torch.from_numpy(a).to(dev) for a in case[9:])


def ptxas_summary(log: str):
    """The registers of each instance and the spilled bytes (stores and
    loads, all instances) that ``nvcc -Xptxas -v`` printed for one source."""
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill", log))
    if not regs:
        raise AssertionError(f"no ptxas report in the build log: {log!r}")
    return {"registers": regs, "spill_bytes": spills}


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| (equal infinities count as equal)."""
    a, b = a.double(), b.double()
    d = (a - b).abs()
    d[a == b] = 0.0
    return float(d.max()) if d.numel() else 0.0


def compare_on_card(case):
    """Kernel vs plain version on the same card inputs: ``affinity_valid``
    always, ``bulk_decide`` too when ``case`` carries strat and warm (11
    arrays, not 9).  Raises unless the outputs are bit-identical (scores
    compared by their bits); returns each compared kernel's largest absolute
    difference over its outputs, and ``bulk_decide``'s winners (or None)."""
    ins, extra = on_card(case)
    shape = (ins[1].shape[0], *ins[0].shape)
    v_k = affinity_valid(*ins)
    v_p = affinity_valid_ref(*ins)
    torch.cuda.synchronize()
    if not torch.equal(v_k, v_p):
        raise AssertionError(f"affinity_valid differs from its plain version "
                             f"at (F, W, T) = {shape}")
    errs = {"affinity_valid": max_abs_err(v_k, v_p)}
    if not extra:
        return errs, None
    b_k = bulk_decide(*ins, *extra)
    b_p = bulk_decide_ref(*ins, *extra)
    torch.cuda.synchronize()
    for name, k, p in zip(("valid", "score", "winner"), b_k, b_p):
        if name == "score":
            k, p = k.view(torch.int32), p.view(torch.int32)
        if not torch.equal(k, p):
            raise AssertionError(f"bulk_decide {name} differs from its "
                                 f"plain version at (R, W, T) = {shape}")
    errs["bulk_decide"] = max(max_abs_err(k, p) for k, p in zip(b_k, b_p))
    return errs, b_k[2]


def compare_kernel_case(case):
    """``compare_on_card`` on a ``kernel_case``, plus its special rows: row 0
    (all tied) must pick worker 0 and row 1 (no valid worker) must win -1."""
    errs, winner = compare_on_card(case)
    if int(winner[0]) != 0:
        raise AssertionError("an all-tied row did not pick its lowest index")
    if winner.numel() > 1 and int(winner[1]) != -1:
        raise AssertionError("a row with no valid worker did not win -1")
    return errs


def worst(errs, got):
    """Per kernel, the larger of two largest absolute differences."""
    return {k: max(v, got.get(k, 0.0)) for k, v in errs.items()}


# --------------------------------------------------------------------------- #
# timing
# --------------------------------------------------------------------------- #


def cuda_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(tensors_in, tensors_out, R: int, W: int, T: int):
    """Least time for the function: every input read once, every output
    written once, over HBM; or its two 0/1 contractions over the tag axis
    (R W T multiply-adds each) at the int8 tensor rate — the larger."""
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*tensors_in, *tensors_out))
    ops = 2 * 2 * R * W * T
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def main_path_inputs(plat: Platform):
    """The kernels' inputs as the main path builds them from the session's
    live state tensors and the rig's compiled block rows: each function's
    per-arrival rows (``affinity_valid``), by function, and a wave's rows
    for all three functions (``bulk_decide``), with the pool's warmth
    ranks."""
    session = plat.session
    snap = session.tensors()
    pol = session.policies_for()
    T = snap.occ.shape[1]
    W = len(snap.workers)
    names = sorted(FUNCTIONS)
    banks = [pol.rows_for(FUNCTIONS[f][1]) for f in names]
    aff = np.concatenate([b.aff_at(T) for b in banks])
    R = aff.shape[0]
    f_mem = np.concatenate([np.full(len(b.cbs), FUNCTIONS[f][0], np.float32)
                            for f, b in zip(names, banks)])
    cap = np.concatenate([b.cap for b in banks]).astype(np.float32)
    conc = np.concatenate([b.conc for b in banks])
    warm = np.zeros((R, W), np.int32)
    rows = {}
    r0 = 0
    for f, b in zip(names, banks):
        rows[f] = slice(r0, r0 + len(b.cbs))
        for w, rank in plat.pool.warmth_row(f, 0.0).items():
            warm[rows[f], snap.widx[w]] = rank
        r0 += len(b.cbs)
    wmask = np.ones((R, W), bool)  # every block is a wildcard
    wave = (snap.occ, aff, wmask, snap.mem_used, snap.max_mem, snap.n_funcs,
            f_mem, cap, conc, np.zeros(R, np.int32), warm)
    arrivals = {f: (snap.occ, aff[s], wmask[s], snap.mem_used, snap.max_mem,
                    snap.n_funcs, f_mem[s], cap[s], conc[s])
                for f, s in rows.items()}
    return arrivals, wave


def device_split(fn, iters: int = 50, attempts: int = 3):
    """Device time per call by kernel (and copy) name, from
    ``torch.profiler``: ``{name: {"ms": ms per call, "per_call": events per
    call}}``; empty when the profiler sees no device activity.  A trace
    that lost events (a count that is not a whole number of calls) is taken
    again, up to ``attempts`` times; the last one is returned as it is."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        split = {e.key: {"ms": e.self_device_time_total / iters / 1e3,
                         "per_call": e.count / iters}
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and e.self_device_time_total > 0}
        if all(v["per_call"] == int(v["per_call"]) for v in split.values()):
            break
    return split


def device_ms(fn, iters: int = 50):
    """Device time per call, summed over every CUDA kernel and copy the call
    enqueued, from ``torch.profiler``; ``None`` when the profiler sees no
    device activity (then the device time is not measured)."""
    split = device_split(fn, iters)
    return sum(v["ms"] for v in split.values()) if split else None


def time_kernel(name: str, case):
    """The kernel's wrapper and its plain version on the same card inputs:
    CUDA-event ms per call (the wrapper's host work included), profiler
    device ms per call and its split by kernel name, and the bound.
    ``case`` has 9 arrays for ``affinity_valid`` and 11 (with strat, warm)
    for ``bulk_decide``.  Raises unless a call is one launch of one kernel
    on the card (no copy, no memset)."""
    ins, extra = on_card(case)
    F, (W, T) = ins[1].shape[0], ins[0].shape
    if name == "affinity_valid":
        kern = lambda: affinity_valid(*ins)  # noqa: E731
        plain = lambda: affinity_valid_ref(*ins)  # noqa: E731
    else:
        kern = lambda: bulk_decide(*ins, *extra)  # noqa: E731
        plain = lambda: bulk_decide_ref(*ins, *extra)  # noqa: E731
    out = kern()
    b_ms, b_by = bound((*ins, *extra), out if isinstance(out, tuple)
                       else (out,), F, W, T)
    split = device_split(kern)
    if split and sum(v["per_call"] for v in split.values()) != 1:
        raise AssertionError(f"{name} at {(F, W, T)} is not one launch a "
                             f"call: {split}")
    return {"shape": [F, W, T], "ms": cuda_ms(kern),
            "plain_ms": cuda_ms(plain),
            "device_ms": sum(v["ms"] for v in split.values()) if split
            else None,
            "device_split": split,
            "plain_device_ms": device_ms(plain), "bound_ms": b_ms,
            "bound_by": b_by}


def host_ms(fn, iters: int = 200) -> float:
    """Host wall ms per call of a call that returns host data (so the device
    work is done when it returns)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3



# the parent commit's affinity entry points (PR 15's sources): a scratch
# buffer of int32 words where the current bulk entry takes its key buffer
# and the current valid entry nothing
OLD_VALID_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int64] * 3 + [
    ctypes.c_void_p]


def old_scratch_words(R: int, W: int, T: int, bulk: bool) -> int:
    """The int32 scratch words the parent's entry takes: packed masks
    (2 R NW + NW W), and for bulk_decide 8-byte aligned R ceil(W / 256)
    uint64 partials."""
    nw = (T + 31) // 32
    words = 2 * R * nw + nw * W
    return words + (words & 1) + 2 * R * (-(-W // 256)) if bulk else words


def affinity_entry(kernel, ins, extra=(), old: bool = False):
    """The bare ctypes entry point of an affinity kernel on these card
    inputs: ``kernel`` has ``bulk_decide_launch``'s signature when
    ``extra`` holds strat and warm, else ``affinity_valid_launch``'s (the
    parent commit's with ``old``).  Outputs, key buffer or scratch are
    allocated and every argument converted to its ctypes type once: a call
    with none of the wrappers' Python.  Returns the call, which holds the
    tensors it reads and writes, and the outputs."""
    occ, aff, wmask, mem, maxm, nfn, f_mem, cap, conc = ins
    (W, T), R, dev = occ.shape, aff.shape[0], occ.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    valid = torch.empty((R, W), dtype=torch.bool, device=dev)
    scratch = (torch.empty((old_scratch_words(R, W, T, bool(extra)),),
                           dtype=torch.int32, device=dev),) if old else ()
    if extra:
        outs = (valid, torch.empty((R, W), dtype=torch.float32, device=dev),
                 torch.empty((R,), dtype=torch.int32, device=dev))
        keys = scratch or (bulk_kernel.ROW_KEYS.get(R, dev, stream),)
        tensors = (aff, f_mem, cap, conc, extra[0], occ, mem, maxm, nfn,
                   wmask, extra[1], *outs, *keys)
    else:
        outs = (valid,)
        tensors = (aff, f_mem, cap, conc, occ, mem, maxm, nfn, wmask, valid,
                   *scratch)
    fn = kernel.fn()
    args = (*(ctypes.c_void_p(t.data_ptr()) for t in tensors),
            *(ctypes.c_int64(v) for v in (R, W, T)), ctypes.c_void_p(stream))

    def call(buffers=tensors):  # alive as long as the call
        return fn(*args)

    rc = call()
    if rc != 0:
        raise AssertionError(f"{kernel.name}: the bare launch failed: CUDA "
                             f"error {rc}")
    return call, outs


def affinity_call_split(name: str, case):
    """Where an affinity call's time goes at one shape: the bare ctypes
    entry, the checked kernel wrapper and the package entry, back to back,
    each by CUDA events and by host enqueue microseconds (no
    synchronisation)."""
    ins, extra = on_card(case)
    if name == "affinity_valid":
        kern = AFFINITY_VALID_KERNEL
        checked = lambda: affinity_kernel.affinity_valid_kernel(*ins)  # noqa: E731
        package = lambda: affinity_valid(*ins)  # noqa: E731
        extra = ()
    else:
        kern = BULK_DECIDE_KERNEL
        checked = lambda: bulk_kernel.bulk_decide_kernel(*ins, *extra)  # noqa: E731
        package = lambda: bulk_decide(*ins, *extra)  # noqa: E731
    bare, _ = affinity_entry(kern, ins, extra)
    split = {}
    for part, fn in (("bare_entry", bare), ("kernel_wrapper", checked),
                     ("package_entry", package), ("bare_entry_again", bare)):
        split[f"{part}_ms"] = cuda_ms(fn)
        torch.cuda.synchronize()
        split[f"{part}_host_us"] = 1e3 * host_ms(fn)
        torch.cuda.synchronize()
    return split


def time_affinity_baseline(base_dir: Path, cases):
    """The parent commit's two affinity kernels (``affinity_valid.cu``,
    ``bulk_decide.cu`` and their header in ``base_dir``), built under other
    names, against the current ones through both bare entries, on the same
    card inputs at each of ``cases`` ({label: (kernel name, case)}): CUDA-
    event and profiler device ms in turns (old, new, new, old), the old
    kernels' device split by kernel name, and the old outputs held to the
    plain versions bit for bit."""
    current = {"affinity_valid": AFFINITY_VALID_KERNEL,
               "bulk_decide": BULK_DECIDE_KERNEL}
    old = {name: type(k)(f"{name}_baseline", str((base_dir / k.source.name)
                                                 .resolve()),
                         entry=k.entry,
                         argtypes=(OLD_VALID_ARGTYPES
                                   if name == "affinity_valid"
                                   else k.argtypes),
                         headers=(str((base_dir / "affinity_common.cuh")
                                      .resolve()),),
                         flags=k.flags)
           for name, k in current.items()}
    for k in old.values():
        k.library_path().unlink(missing_ok=True)
    build_all(list(old.values()))
    out = {"registers": {k.name: ptxas_summary(k.build_log)
                         for k in old.values()}}
    for label, (name, case) in cases.items():
        ins, extra = on_card(case)
        extra = extra if name == "bulk_decide" else ()
        call_old, got_old = affinity_entry(old[name], ins, extra, old=True)
        call_new, got_new = affinity_entry(current[name], ins, extra)
        torch.cuda.synchronize()
        want = (bulk_decide_ref(*ins, *extra) if extra
                else (affinity_valid_ref(*ins),))
        for got in (got_old, got_new):
            for g, w in zip(got, want):
                if g.dtype == torch.float32:
                    g, w = g.view(torch.int32), w.view(torch.int32)
                if not torch.equal(g, w):
                    raise AssertionError(f"{name} at {label}: a bare entry "
                                         "differs from the plain version")
        timed = collections.defaultdict(list)
        for which, fn in (("old", call_old), ("new", call_new),
                          ("new", call_new), ("old", call_old)):
            timed[f"{which}_ms"].append(cuda_ms(fn))
            timed[f"{which}_device_ms"].append(device_ms(fn))
        timed["old_device_split"] = device_split(call_old)
        timed["new_device_split"] = device_split(call_new)
        out[label] = {"kernel": name,
                      "shape": [ins[1].shape[0], *ins[0].shape], **timed}
    return out


# --------------------------------------------------------------------------- #
# flash attention and the serving path
# --------------------------------------------------------------------------- #

#: (B, Sq, Skv, H, K, hd, causal, window): ragged lengths (Sq = 1, 200,
#: 257), Sq != Skv non-causal, GQA ratios H / K of 1, 2 and 4, head dims 64,
#: 128 and 256, window 1 and a window past the sequence, and causal with a
#: window at Sq > Skv and Sq < Skv (the kernel's key-tile bounds)
FLASH_CASES = [
    (1, 1, 1, 2, 1, 64, True, None),
    (2, 200, 200, 4, 2, 64, True, None),
    (1, 257, 257, 8, 4, 128, True, None),
    (1, 257, 257, 4, 4, 256, True, 64),
    (1, 128, 384, 4, 2, 64, False, None),
    (1, 257, 100, 8, 2, 256, False, None),
    (1, 300, 300, 8, 4, 256, True, 1),
    (1, 300, 300, 8, 8, 128, True, 1024),
    (1, 1000, 1000, 8, 2, 128, True, 100),
    (1, 300, 200, 8, 4, 256, True, 128),
    (1, 200, 300, 4, 2, 64, True, 50),
]


def flash_inputs(B, Sq, Skv, H, K, hd, dtype, seed: int):
    """Seeded standard-normal q [B,Sq,H,hd], k / v [B,Skv,K,hd] on the
    card, rounded to ``dtype``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device="cuda").to(dtype)
                 for shape in ((B, Sq, H, hd), (B, Skv, K, hd),
                               (B, Skv, K, hd)))


def flash_bf16_bound(q, k, v, causal, window):
    """The plain version on q, k, v widened to float32, and the tolerance
    each element of a bf16 kernel output is held to against it (see
    FLASH_TOL)."""
    q, k, v = (t.float() for t in (q, k, v))
    want = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
    spread = fa.flash_attention_ref(q, k, v.abs(), causal=causal,
                                    window=window)
    return want, BF16_ROUNDING * (want.abs() + 2 * spread)


def tile_rows_seen(Sq: int, Skv: int, causal: bool, window, tile: int,
                   every: bool = True) -> torch.Tensor:
    """[Sq] bool: the query rows that see every key of 64-key tile ``tile``
    (``every``), or some key of it."""
    qi = torch.arange(Sq)
    a, b = tile * FLASH_TILE, min((tile + 1) * FLASH_TILE, Skv) - 1
    lo, hi = (a, b) if every else (b, a)
    rows = torch.ones(Sq, dtype=torch.bool)
    if causal:
        rows &= qi >= hi
    if window is not None:
        rows &= lo > qi - window
    return rows


def dropped_tile(Sq: int, Skv: int, causal: bool, window) -> int:
    """The 64-key tile the control on the whole inputs drops: the first one,
    or under a window the one that the most query rows see (the first of
    those)."""
    if window is None:
        return 0
    seen = [int(tile_rows_seen(Sq, Skv, causal, window, t,
                               every=False).sum())
            for t in range(-(-Skv // FLASH_TILE))]
    return seen.index(max(seen))


def late_tile(Sq: int, Skv: int, causal: bool) -> int:
    """A 64-key tile that only late query rows see: under a causal mask the
    one before the last row's diagonal tile (or the first, when that is the
    diagonal's), else the last."""
    last = (min(Sq, Skv) if causal else Skv) - 1
    return max(last // FLASH_TILE - 1, 0) if causal else last // FLASH_TILE


def tile_rows(v: torch.Tensor, tile: int, keep: bool) -> torch.Tensor:
    """``v`` with the key rows of 64-key tile ``tile`` zeroed, or with every
    other key row zeroed (``keep``)."""
    a = tile * FLASH_TILE
    if keep:
        out = torch.zeros_like(v)
        out[:, a:a + FLASH_TILE] = v[:, a:a + FLASH_TILE]
        return out
    out = v.clone()
    out[:, a:a + FLASH_TILE] = 0
    return out


def flash_bf16_check(got, q, k, v, causal, window, tile: int):
    """A bf16 output ``got`` for q, k, v (the kernel's) against the plain
    version on them widened to float32 (:func:`flash_bf16_bound`), and the
    control: the plain version with the v rows of 64-key tile ``tile``
    zeroed.  Raises unless every element is within its tolerance and the
    control moves some element of a row that sees the whole tile (else of
    one that sees some of it) by at least FLASH_DROP x its tolerance (an
    element whose tolerance is 0, a row that sees no key of a v that is
    zero there, must match exactly).  Returns the key tile, the largest
    difference, the largest difference over its element's tolerance, the
    control's largest difference over tolerance, and the medians of the
    tolerance and of |output| over the elements whose tolerance is not
    0."""
    want, tol = flash_bf16_bound(q, k, v, causal, window)
    if got.dtype != q.dtype or got.shape != want.shape:
        raise AssertionError("flash_attention returned another dtype or "
                             "shape than its inputs")

    def over(d, rows=slice(None)):  # the largest d / tol, 0 / 0 as 0
        return float((d / tol)[:, rows].nan_to_num(nan=0.0).max())

    diff = (got.float() - want).abs()
    err = over(diff)
    where = f"at q {tuple(q.shape)}, k {tuple(k.shape)}, causal={causal}, " \
            f"window={window}, key tile {tile}"
    if not bool((diff <= tol).all()):
        raise AssertionError(
            f"bf16 flash_attention differs from its plain version by "
            f"{err} x the tolerance of an element "
            f"(max abs err {float(diff.max())}) {where}")
    dropped = fa.flash_attention_ref(q.float(), k.float(),
                                     tile_rows(v.float(), tile, keep=False),
                                     causal=causal, window=window)
    Sq, Skv = q.shape[1], k.shape[1]
    rows = tile_rows_seen(Sq, Skv, causal, window, tile)
    if not rows.any():
        rows = tile_rows_seen(Sq, Skv, causal, window, tile, every=False)
    drop = over((dropped - want).abs(), rows.to(want.device))
    if not drop >= FLASH_DROP:
        raise AssertionError(
            f"dropping a key tile moves the plain version by at most {drop} "
            f"x the bf16 tolerance, under {FLASH_DROP}, {where}")
    return {"tile": tile, "max_abs_err": float(diff.max()),
            "err_over_tol": err, "drop_over_tol": drop,
            "median_tol": float(tol[tol > 0].median()),
            "median_abs_output": float(want.abs()[tol > 0].median())}


def compare_flash(q, k, v, causal, window):
    """The flash kernel against its plain version on the same card inputs;
    raises past the tolerance.  float32: returns the largest difference.
    bf16: :func:`flash_bf16_check` on the whole inputs (the control drops
    :func:`dropped_tile`) and on v restricted to :func:`late_tile`; returns
    the largest difference of the two and both checks' numbers."""
    if q.dtype == torch.bfloat16:
        Sq, Skv = q.shape[1], k.shape[1]
        kw = dict(causal=causal, window=window)
        whole = flash_bf16_check(fa.flash_attention(q, k, v, **kw), q, k, v,
                                 tile=dropped_tile(Sq, Skv, causal, window),
                                 **kw)
        t = late_tile(Sq, Skv, causal)
        v = tile_rows(v, t, keep=True)
        late = flash_bf16_check(fa.flash_attention(q, k, v, **kw), q, k, v,
                                tile=t, **kw)
        return (max(whole["max_abs_err"], late["max_abs_err"]),
                {"whole": whole, "late": late})
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    if got.dtype != q.dtype or got.shape != want.shape:
        raise AssertionError("flash_attention returned another dtype or "
                             "shape than its inputs")
    err = max_abs_err(got.float(), want)
    if not err <= FLASH_TOL[q.dtype]:
        raise AssertionError(
            f"flash_attention differs from its plain version by {err} "
            f"(tolerance {FLASH_TOL[q.dtype]}) at q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, {q.dtype}, causal={causal}, window={window}")
    return err, None


def session_prompt(session: str, vocab: int) -> torch.Tensor:
    """A seeded prompt of PROMPT token ids for one session (the same for
    either model of the serving runs)."""
    g = torch.Generator(device="cuda").manual_seed(100 + int(session[1:]))
    return torch.randint(0, vocab, (1, PROMPT), generator=g, device="cuda")


class ServeRunner:
    """The runner ``launch/serve.py`` gives the engine, on the full model: a
    prefill runs the prefill step (attention through the flash kernel, mamba
    layers through the scan kernel) on the session's prompt and makes an
    empty cache (the JAX package has no prefill-into-cache for LMs); a
    decode runs ``model_decode_step`` on the session's last token.  It keeps
    each request's host seconds and whether every logit was finite."""

    def __init__(self, cfg, model):
        self.cfg, self.model = cfg, model
        self.prefill = make_prefill_step(cfg, impl="flash")
        self.caches, self.last = {}, {}
        self.prefill_s, self.decode_s = [], []
        self.finite = True

    def __call__(self, req: Request, cell: str):
        if req.kind == "prefill":
            tokens = session_prompt(req.session, self.cfg.vocab)
            t0 = time.perf_counter()
            logits = self.prefill(self.model, {"tokens": tokens})
            self.finite &= bool(torch.isfinite(logits).all())
            self.prefill_s.append(time.perf_counter() - t0)
            self.caches[(req.session, cell)] = init_cache(self.cfg, 1,
                                                          MAX_LEN)
            self.last[req.session] = int(tokens[0, -1])
            return int(logits[0].argmax())
        if req.kind == "decode":
            key = (req.session, cell)
            tok = torch.full((1, 1), self.last[req.session],
                             dtype=torch.long, device="cuda")
            t0 = time.perf_counter()
            with torch.no_grad():
                logits, self.caches[key] = model_decode_step(
                    self.cfg, self.model, self.caches[key], tok)
            self.finite &= bool(torch.isfinite(logits).all())
            self.last[req.session] = int(logits[0].argmax())
            self.decode_s.append(time.perf_counter() - t0)
            return self.last[req.session]
        raise ValueError(f"the serving run sends no {req.kind!r} requests")


class FlashCapture:
    """Stands in for the package's ``flash_attention`` during the serving
    run and keeps the q / k / v of the first global (no window) and the
    first local (windowed) call; every call goes on to the kernel."""

    def __init__(self):
        self.kernel = fa.flash_attention
        self.seen = {}

    def __call__(self, q, k, v, *args, **kw):
        kind = "global" if kw.get("window") is None else "local"
        self.seen.setdefault(kind, (q, k, v, kw.get("causal", True),
                                    kw.get("window")))
        return self.kernel(q, k, v, *args, **kw)


def drive_serving(cfg, model):
    """The serving path once: ``launch/serve.py``'s engine and deployment,
    SESSIONS prefills, DECODES decodes drawn from a seeded generator, and
    session s0's cell failed before decode FAIL_AT.  Returns the engine,
    the runner, the host us of scheduling per submitted request (the
    submit's wall time less the runner's), the failed cell, the sessions
    it moved, and whether every decode ran on its session's cell."""
    runner = ServeRunner(cfg, model)
    with warnings.catch_warnings():  # the v1 call shape, as launch/serve.py
        warnings.simplefilter("ignore", DeprecationWarning)
        eng = Engine(two_pod_cells(), runner=runner, heartbeat_timeout=1e9)
    eng.deploy(cfg.name, DEPLOY, weights_gb=8)
    sched_us = []

    def submit(req):
        t0 = time.perf_counter()
        c = eng.submit(req)
        sched_us.append((time.perf_counter() - t0 - c.latency) * 1e6)
        return c

    sessions = [f"s{i}" for i in range(SESSIONS)]
    for s in sessions:
        submit(Request(model=cfg.name, kind="prefill", session=s))
    order = random.Random(5)
    victim, moved, stayed = None, [], True
    for i in range(DECODES):
        if i == FAIL_AT:
            victim = eng.session_cell("s0")
            moved = eng.fail_cell(victim)
        s = order.choice(sessions)
        c = submit(Request(model=cfg.name, kind="decode", session=s))
        stayed &= c.ok and c.cell == eng.session_cell(s)
    return eng, runner, sched_us, victim, moved, stayed


def device_breakdown(fn, marker: str, label: str, iters: int = 3):
    """Where one call's time goes on the card: ``torch.profiler`` over
    ``iters`` calls after one warm-up, the device time summed by kernel
    name into the port's kernel (names holding ``marker``, reported as
    ``<label>_ms``), matrix products (cuBLAS / CUTLASS kernel names) and
    the rest, beside the host wall time of the same calls under the
    profiler; idle share = 1 - device time / wall time.  Kernels of one
    stream do not overlap, so their sum is the device's busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / iters * 1e3
    by_name = {e.key: e.self_device_time_total / iters / 1e3
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA}
    own = sum(v for k, v in by_name.items() if marker in k)
    matmul = sum(v for k, v in by_name.items() if marker not in k and
                 any(m in k.lower() for m in ("gemm", "nvjet", "xmma",
                                              "cutlass")))
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"wall_ms": wall_ms, "device_ms": busy,
            "idle_share": 1.0 - busy / wall_ms, f"{label}_ms": own,
            "matmul_ms": matmul, "other_ms": busy - own - matmul,
            "kernels": len(by_name),
            "top": [[k[:80], v] for k, v in top]}


def whole_model_f32(base):
    """One local:global period of ``base`` (gemma3-4b) at full width in
    float32: the prefill's logits through the float32 flash kernel against
    the direct path, on the same card and weights; the float32 kernel must
    run once per layer and the bf16 kernel not at all.  Returns the largest
    difference, the largest logit and the float32 kernel's launches."""
    cfg = dataclasses.replace(base, n_layers=base.period, dtype="float32")
    model = init_model(cfg, torch.Generator(device="cuda").manual_seed(1))
    g = torch.Generator(device="cuda").manual_seed(6)
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, F32_PROMPT), generator=g,
                                     device="cuda")}
    for kern in fa.KERNELS:
        kern.launches = 0
    flash = make_prefill_step(cfg, impl="flash")(model, batch)
    launches = {kern.name: kern.launches for kern in fa.KERNELS}
    direct = make_prefill_step(cfg, impl="direct")(model, batch)
    torch.cuda.synchronize()
    err = max_abs_err(flash, direct)
    if not err <= MODEL_F32_TOL or launches != {
            "flash_attention": cfg.n_layers, "flash_attention_bf16": 0}:
        raise AssertionError(f"float32 gemma3-4b period: flash vs direct "
                             f"logits differ by {err} (bound "
                             f"{MODEL_F32_TOL}), flash launches {launches}")
    return err, float(direct.abs().max()), launches["flash_attention"]


def masked_pairs(S: int, window) -> int:
    """(query, key) pairs a causal mask (with ``window``) admits at
    Sq = Skv = S."""
    if window is None:
        return S * (S + 1) // 2
    return sum(min(i + 1, window) for i in range(S))


def time_flash(dtype, window, seed: int):
    """The flash kernel for ``dtype`` at the serving path's shape
    (1, 4096, 8, 4, 256), causal with ``window``: CUDA-event ms per call,
    profiler device ms, the plain version's ms,
    ``scaled_dot_product_attention``'s CUDA-event and device ms on the same
    inputs (causal with
    ``enable_gqa``; the window as an explicit mask) and the bound: the
    larger of every input read once and the output written once over HBM,
    and the mask's useful multiply-adds (q k^T and p v, 4 hd flops per
    admitted pair and head) at the peak rate for the type (dense bf16 on the
    tensor cores; float32 on the CUDA cores, since a TF32 product would not
    hold the float32 tolerance)."""
    import torch.nn.functional as F

    B, S, H, K, hd = 1, PROMPT, 8, 4, 256
    q, k, v = flash_inputs(B, S, S, H, K, hd, dtype, seed)
    kern = lambda: fa.flash_attention(q, k, v, causal=True,  # noqa: E731
                                      window=window)
    plain = lambda: fa.flash_attention_ref(  # noqa: E731
        q, k, v, causal=True, window=window)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window is None:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
    else:
        i = torch.arange(S, device="cuda")
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
    nbytes = q.element_size() * (q.numel() + k.numel() + v.numel() +
                                 q.numel())
    flops = 4 * hd * H * masked_pairs(S, window)
    peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return {"shape": [B, S, H, K, hd], "dtype": str(dtype)[6:],
            "window": window,
            "ms": cuda_ms(kern, iters=50, warmup=5),
            "device_ms": device_ms(kern, iters=20),
            "plain_ms": cuda_ms(plain, iters=10, warmup=2),
            "library_ms": cuda_ms(lib, iters=50, warmup=5),
            "library_device_ms": device_ms(lib, iters=20),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "useful_gflop": flops / 1e9, "mbytes": nbytes / 1e6}

def serve_whole(cfg, package, name: str, capture):
    """``cfg`` whole behind ``serve.Engine``: weights drawn on the card,
    ``capture`` standing in for ``package.<name>`` (the port's kernel
    entry the model calls) during the run, every launch counter set to 0
    just before the run and read just after, and the run's checks: every
    completion ok, every decode on its session's cell, every logit finite,
    the failed cell's sessions re-prefilled, placements through
    ``affinity_valid``.  Returns the model, the engine, the runner, the
    scheduling us per request and the launches."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    setattr(package, name, capture)
    for k in ALL_KERNELS:
        k.launches = 0
    try:
        eng, runner, sched_us, victim, moved, stayed = drive_serving(cfg,
                                                                     model)
    finally:
        setattr(package, name, capture.kernel)
    launches = {k.name: k.launches for k in ALL_KERNELS}
    n_prefills = len(runner.prefill_s)
    bad = [c for c in eng.completions if not c.ok]
    if bad or not stayed or not runner.finite:
        raise AssertionError(f"serving {cfg.name}: {len(bad)} failed "
                             f"completions, decodes on their session's cell:"
                             f" {stayed}, logits finite: {runner.finite}")
    if not moved or victim is None or n_prefills != SESSIONS + len(moved):
        raise AssertionError(f"serving {cfg.name}: failing {victim} moved "
                             f"{moved}; {n_prefills} prefills ran")
    if launches["affinity_valid"] == 0:
        raise AssertionError(f"serving {cfg.name}: no placement reached "
                             f"affinity_valid ({launches})")
    print(f"serving path: {cfg.name} whole ({cfg.n_layers} layers, "
          f"{n_params / 1e9:.3f} B parameters, bf16, drawn on the card in "
          f"{init_s:.2f} s) behind serve.Engine on {len(two_pod_cells())} "
          f"cells; {SESSIONS} prefills of {PROMPT} tokens, {DECODES} decodes"
          f", cell {victim} failed before decode {FAIL_AT} (re-prefilled "
          f"{moved}); {len(eng.completions)} completions ok, decodes on "
          f"their session's cell, logits finite; launches {launches} "
          f"({n_prefills} prefills x {cfg.n_layers})", flush=True)
    return model, eng, runner, sched_us, launches


def serving_path(cfg):
    """Phase 6: ``cfg`` whole behind ``serve.Engine`` (:func:`serve_whole`),
    the bf16 flash counter checked at one launch per layer and prefill and
    the float32 one at none, and both flash kernels held to the plain
    version on the q / k / v the run captured (bf16 as captured, and the
    float32 kernel on them widened).  Returns the launches, those
    comparisons' errors and the run's end-to-end numbers."""
    capture = FlashCapture()
    model, eng, runner, sched_us, serve_launches = serve_whole(
        cfg, fa, "flash_attention", capture)
    n_prefills = len(runner.prefill_s)
    if serve_launches["flash_attention_bf16"] != cfg.n_layers * n_prefills \
            or serve_launches["flash_attention"] != 0:
        raise AssertionError(f"serving path launches {serve_launches} for "
                             f"{n_prefills} prefills of {cfg.n_layers} "
                             "layers")
    main, main_err, main_f32 = {}, {}, {}
    for kind in ("local", "global"):
        q, k, v, causal, window = capture.seen[kind]
        main_err[kind], main[kind] = compare_flash(q, k, v, causal, window)
        q, k, v = (t.float() for t in (q, k, v))
        main_f32[kind] = compare_flash(q, k, v, causal, window)[0]
    print(f"flash_attention vs plain at the serving path's inputs (the first"
          f" local and global layer of the first prefill, "
          f"{tuple(capture.seen['local'][0].shape)}): the bf16 kernel per "
          f"element within tolerance, on the whole inputs and on v "
          f"restricted to a late key tile, each with its dropped-tile "
          f"control (at least {FLASH_DROP} x tolerance) "
          f"{json.dumps(main)}; the float32 kernel on the same inputs "
          f"widened, max abs err {main_f32} (tolerance "
          f"{FLASH_TOL[torch.float32]})", flush=True)
    serving = serving_numbers(cfg, model, runner, sched_us,
                              "flash_fwd_bf16_sm90", "flash")
    serving["flash_vs_plain_main_path"] = {
        "bf16": main, "float32_err": main_f32}
    return serve_launches, main_err, main_f32, serving


def serving_numbers(cfg, model, runner, sched_us, marker: str, label: str):
    """A serving run's end-to-end numbers (prefill ms and tokens/s, decode
    ms per token, scheduling us per request, peak memory) and where one
    prefill's and one decode step's time goes on the card
    (:func:`device_breakdown`, the port's kernel picked out by
    ``marker``)."""
    tokens = session_prompt("s0", cfg.vocab)
    prefill = make_prefill_step(cfg, impl="flash")
    state = {"cache": init_cache(cfg, 1, MAX_LEN)}
    tok = tokens[:, -1:]

    def decode():
        with torch.no_grad():
            _, state["cache"] = model_decode_step(cfg, model, state["cache"],
                                                  tok)

    breakdown = {"prefill": device_breakdown(
                     lambda: prefill(model, {"tokens": tokens}), marker,
                     label),
                 "decode": device_breakdown(decode, marker, label, iters=8)}
    prefill_ms = [t * 1e3 for t in runner.prefill_s]
    decode_ms = [t * 1e3 for t in runner.decode_s]
    serving = {
        "prefill_ms": prefill_ms,
        "prefill_ms_median": statistics.median(prefill_ms),
        "prefill_tokens_per_s_median": PROMPT / statistics.median(
            runner.prefill_s),
        "decode_ms_per_token_median": statistics.median(decode_ms),
        "decode_ms_per_token_mean": statistics.mean(decode_ms),
        "sched_us_per_request_median": statistics.median(sched_us),
        "sched_us_per_request_mean": statistics.mean(sched_us),
        "requests": len(sched_us),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "breakdown": breakdown}
    return serving



# --------------------------------------------------------------------------- #
# the selective scan and the SSM serving path
# --------------------------------------------------------------------------- #

#: (B, S, D, N, dtype): the four shapes of tests/test_kernels.py's sweep,
#: then shapes around the kernel's tiling (ms.kernel: chunks of CHUNK = 64
#: steps, tiles of CHANNEL_TILE = 32 channels, groups of GROUP = 8 steps):
#: S below one group, below one chunk, off a group and a chunk multiple
#: over several chunks; D below one tile and off a tile multiple, on a
#: multiple of 8 (cp.async staging) and off it (plain-load staging, as is
#: B > 1 with S N off a multiple of 8); every N (each K = min(N, 4)
#: instance); float32 and bfloat16 inputs (dt, x, b, c; a is float32)
SCAN_CASES = [
    (2, 64, 32, 4, "float32"),
    (1, 100, 48, 16, "float32"),
    (2, 128, 64, 8, "float32"),
    (1, 48, 16, 2, "float32"),
    (2, 333, 1000, 16, "float32"),
    (1, 257, 97, 1, "float32"),
    (1, 200, 130, 32, "float32"),
    (1, 5, 8, 8, "float32"),
    (1, 300, 520, 16, "bfloat16"),
    (2, 129, 64, 32, "bfloat16"),
    (3, 77, 40, 2, "bfloat16"),
    (2, 1, 33, 1, "bfloat16"),
    (1, 203, 72, 4, "bfloat16"),
]
#: the long-memory case: a = -0.01 exp(normal), so exp(dt a) stays within
#: ~1e-3 of 1 and the state carries ~1000 steps; S over 32 chunks and
#: ragged, D off a tile, the serving path's types (dt float32, x / b / c
#: bf16).  Held to SCAN_TOL of max(1, max |y|); its control, the plain
#: version with the state reset at a chunk boundary (SCAN_CUT), must differ
#: from the whole run by at least SCAN_CARRY x that tolerance
SCAN_LONG = (1, 2085, 264, 16)
SCAN_LONG_A = 0.01
SCAN_CUT = 1024
SCAN_CARRY = 100.0


def scan_inputs(B, S, D, N, dtype: str, seed: int, a_scale: float = 1.0):
    """Seeded inputs on the card, drawn as tests/test_kernels.py draws them:
    dt = 0.1 softplus(normal), x, b, c normal, a = -a_scale exp(normal)
    [D, N] float32; dt, x, b, c rounded to ``dtype``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    randn = functools.partial(torch.randn, generator=g, device="cuda")
    dt = 0.1 * torch.nn.functional.softplus(randn((B, S, D)))
    x, b, c = randn((B, S, D)), randn((B, S, N)), randn((B, S, N))
    a = -a_scale * torch.exp(randn((D, N)))
    dt_type = getattr(torch, dtype)
    return (*(t.to(dt_type) for t in (dt, x, b, c)), a)


def scan_long_inputs(seed: int):
    """SCAN_LONG's inputs: dt float32, x / b / c bf16, a float32."""
    dt, x, b, c, a = scan_inputs(*SCAN_LONG, "float32", seed,
                                 a_scale=SCAN_LONG_A)
    return (dt, *(t.to(torch.bfloat16) for t in (x, b, c)), a)


def scan_long_memory_check(seed: int):
    """The kernel on SCAN_LONG within SCAN_TOL max(1, max |y|) of its plain
    version, and the control: the plain version run in two halves, the
    state reset at step SCAN_CUT, must differ from the whole run by at
    least SCAN_CARRY x that tolerance, or the check could not see a carry
    lost between chunks.  Returns the error, the tolerance and the
    control's difference over the tolerance."""
    ins = scan_long_inputs(seed)
    err, top, _ = compare_scan(*ins, relative=True)
    dt, x, b, c, a = ins
    whole = ms.selective_scan_ref(*ins)
    halves = torch.cat([ms.selective_scan_ref(dt[:, sl], x[:, sl], b[:, sl],
                                              c[:, sl], a)
                        for sl in (slice(0, SCAN_CUT),
                                   slice(SCAN_CUT, None))], dim=1)
    tol = SCAN_TOL * max(1.0, top)
    ratio = max_abs_err(whole, halves) / tol
    if SCAN_CUT % ms.kernel.CHUNK or not ratio >= SCAN_CARRY:
        raise AssertionError(f"the long-memory control moved y by {ratio} x "
                             f"the tolerance {tol} (at least {SCAN_CARRY})")
    return err, tol, ratio


def compare_scan(dt, x, b, c, a, *, relative: bool = False):
    """The scan kernel against its plain version on the same card inputs;
    raises past SCAN_TOL (times max(1, max |y|) when ``relative``) and
    returns the largest difference and the plain output's largest and
    median |value|."""
    got = ms.selective_scan(dt, x, b, c, a)
    want = ms.selective_scan_ref(dt, x, b, c, a)
    torch.cuda.synchronize()
    if got.dtype != torch.float32 or got.shape != want.shape:
        raise AssertionError("selective_scan returned another dtype or "
                             "shape than its plain version")
    err = max_abs_err(got, want)
    top = float(want.abs().max())
    tol = SCAN_TOL * (max(1.0, top) if relative else 1.0)
    if not err <= tol:
        raise AssertionError(
            f"selective_scan differs from its plain version by {err} (bound "
            f"{tol}) at dt {tuple(dt.shape)} {dt.dtype}, x {x.dtype}, b "
            f"{tuple(b.shape)} {b.dtype}")
    return err, top, float(want.abs().median())


class ScanCapture:
    """Stands in for the package's ``selective_scan`` during the serving
    run and keeps the inputs of its first call (the first layer of the
    first prefill); every call goes on to the kernel."""

    def __init__(self):
        self.kernel = ms.selective_scan
        self.first = None

    def __call__(self, *args, **kw):
        if self.first is None:
            self.first = args
        return self.kernel(*args, **kw)


def ssm_serving_path(cfg):
    """Phase 9: ``cfg`` (falcon-mamba-7b) whole behind ``serve.Engine``
    (:func:`serve_whole`), the scan counter checked at one launch per layer
    and prefill and the flash counters at none, and the scan kernel held to
    its plain version on the first layer's inputs from the first live
    prefill.  Returns the launches, that comparison's error and the run's
    end-to-end numbers."""
    capture = ScanCapture()
    model, eng, runner, sched_us, launches = serve_whole(
        cfg, ms, "selective_scan", capture)
    n_prefills = len(runner.prefill_s)
    if launches["selective_scan"] != cfg.n_layers * n_prefills or \
            launches["flash_attention"] != 0 or \
            launches["flash_attention_bf16"] != 0:
        raise AssertionError(f"SSM serving path launches {launches} for "
                             f"{n_prefills} prefills of {cfg.n_layers} "
                             "mamba layers")
    dt, x, b, c, a = capture.first
    err, top, median = compare_scan(dt, x, b, c, a, relative=True)
    print(f"selective_scan vs plain at the serving path's inputs (the first "
          f"layer of the first prefill: dt {tuple(dt.shape)} {dt.dtype}, x "
          f"{x.dtype}, b / c {tuple(b.shape)} {b.dtype}, a {tuple(a.shape)}):"
          f" max abs err {err} (bound {SCAN_TOL} x max(1, {top})); median "
          f"|output| {median}", flush=True)
    capture.first = None
    serving = serving_numbers(cfg, model, runner, sched_us,
                              "selective_scan_fwd", "scan")
    serving["scan_vs_plain_main_path"] = {
        "max_abs_err": err, "max_abs_output": top,
        "median_abs_output": median}
    return launches, err, serving


def ssm_model_f32(base):
    """falcon-mamba-7b at full width with SSM_F32_LAYERS layers in float32:
    the logits at every position of an F32_PROMPT-token prefill through the
    scan kernel against the same model with the scan on
    ``backend="ref"``, on the same card and weights.  Returns the largest
    difference, the largest logit and the kernel's launches."""
    cfg = dataclasses.replace(base, n_layers=SSM_F32_LAYERS, dtype="float32")
    model = init_model(cfg, torch.Generator(device="cuda").manual_seed(1))
    g = torch.Generator(device="cuda").manual_seed(7)
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, F32_PROMPT),
                                     generator=g, device="cuda")}

    def logits():
        with torch.no_grad():
            return lm_logits(cfg, model, model_forward(cfg, model, batch))

    ms.SELECTIVE_SCAN_KERNEL.launches = 0
    kern = logits()
    launches = ms.SELECTIVE_SCAN_KERNEL.launches
    scan = ms.selective_scan
    ms.selective_scan = functools.partial(scan, backend="ref")
    try:
        plain = logits()
    finally:
        ms.selective_scan = scan
    torch.cuda.synchronize()
    err = max_abs_err(kern, plain)
    top = float(plain.abs().max())
    if not err <= SCAN_TOL * max(1.0, top) or launches != cfg.n_layers:
        raise AssertionError(f"float32 falcon-mamba-7b: kernel vs plain scan "
                             f"logits differ by {err} (bound {SCAN_TOL} x "
                             f"max(1, {top})), {launches} scan launches")
    return err, top, launches


def scan_serving_inputs(seed: int):
    """Seeded inputs at the serving path's shape (1, 4096, 8192, 16) with its
    types (dt float32, x / b / c bf16, a float32)."""
    B, S, D, N = 1, PROMPT, 2 * FALCON_MAMBA_7B.d_model, \
        FALCON_MAMBA_7B.ssm.d_state
    dt, x, b, c, a = scan_inputs(B, S, D, N, "float32", seed)
    return (dt, *(t.to(torch.bfloat16) for t in (x, b, c)), a)


def scan_entry(kernel, dt, x, b, c, a):
    """The bare ctypes entry point of ``kernel`` (a CudaKernel with
    ``selective_scan_launch``'s signature) on these card inputs, with y
    allocated and every argument converted to its ctypes type once: a
    call with none of the wrapper's Python.  Returns the call, which holds
    the tensors it writes and reads, and y."""
    import ctypes

    y = torch.empty(dt.shape, dtype=torch.float32, device=dt.device)
    fn = kernel.fn()
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (dt, x, b, c, a, y)]
    ints = [ctypes.c_int64(v) for v in (*dt.shape, a.shape[1],
                                        *(int(t.dtype == torch.bfloat16)
                                          for t in (dt, x, b, c)))]
    args = (*ptrs, *ints,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))

    def call(buffers=(dt, x, b, c, a, y)):  # alive as long as the call
        return fn(*args)

    rc = call()
    if rc != 0:
        raise AssertionError(f"{kernel.name}: the bare launch failed: CUDA "
                             f"error {rc}")
    return call, y


def time_scan(seed: int, baseline=None):
    """The scan kernel at the serving path's shape and types
    (:func:`scan_serving_inputs`): CUDA-event ms per call through the
    package's ``selective_scan``, profiler device ms, the plain version's
    ms (a Python loop of 4096 steps: a few calls only) and the bound: the
    larger of every input read once and y written once over HBM, and the
    recurrence's float32 operations (7 per (t, d, n): dt a, exp, abar h,
    (dt x) b, the add, h c, the sum over n; 1 per (t, d): dt x) at the CUDA
    cores' float32 rate.  No single PyTorch call computes a selective scan,
    so there is no library time.

    Beside it, where the calls' time goes: the same kernel through its bare
    ctypes entry point (:func:`scan_entry`), through
    ``selective_scan_kernel`` (the checked kernel wrapper) and through the
    package entry, by CUDA events, back to back; and each one's host
    microseconds per call (enqueue only, no synchronisation).  With
    ``baseline`` (a CudaKernel of an earlier ``selective_scan.cu``), that
    kernel's events and device ms on the same inputs, in turns with the
    new one (baseline, new, new, baseline), and its largest difference from
    the plain version."""
    dt, x, b, c, a = ins = scan_serving_inputs(seed)
    B, S, D = dt.shape
    N = a.shape[1]
    kern = lambda: ms.selective_scan(*ins)  # noqa: E731
    checked = lambda: ms.kernel.selective_scan_kernel(*ins)  # noqa: E731
    plain = lambda: ms.selective_scan_ref(*ins)  # noqa: E731
    bare, _ = scan_entry(ms.SELECTIVE_SCAN_KERNEL, *ins)
    nbytes = sum(t.numel() * t.element_size() for t in ins) + B * S * D * 4
    flops = B * S * D * (7 * N + 1)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    out = {"shape": [B, S, D, N], "types": "dt f32, x/b/c bf16, a f32",
           "ms": cuda_ms(kern, iters=50, warmup=5),
           "device_ms": device_ms(kern, iters=20),
           "plain_ms": cuda_ms(plain, iters=2, warmup=1),
           "library_ms": None,
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
           "mufu_floor_ms_at_1.98GHz": B * S * D * N / (16 * 132 * 1.98e9)
           * 1e3}
    out["bound_share_of_device"] = out["bound_ms"] / out["device_ms"] \
        if out["device_ms"] else None
    split = {}
    for name, fn in (("bare_entry", bare), ("kernel_wrapper", checked),
                     ("package_entry", kern), ("bare_entry_again", bare)):
        split[f"{name}_ms"] = cuda_ms(fn, iters=50, warmup=5)
        torch.cuda.synchronize()
        split[f"{name}_host_us"] = 1e3 * host_ms(fn, iters=20)
        torch.cuda.synchronize()
    out["call_split"] = split
    if baseline is not None:
        old, y_old = scan_entry(baseline, *ins)
        torch.cuda.synchronize()
        old_err = max_abs_err(y_old, plain())
        turns = [("baseline", old), ("new", bare), ("new", bare),
                 ("baseline", old)]
        timed = collections.defaultdict(list)
        for name, fn in turns:
            timed[f"{name}_ms"].append(cuda_ms(fn, iters=30, warmup=5))
            timed[f"{name}_device_ms"].append(device_ms(fn, iters=20))
        out["baseline"] = {"source": str(baseline.source),
                           "max_abs_err_vs_plain": old_err,
                           "registers": ptxas_summary(baseline.build_log),
                           **timed}
    return out


# --------------------------------------------------------------------------- #
# 12. the trace-driven decision path: TraceWorkload on ClusterSim
# --------------------------------------------------------------------------- #

# the cluster: benchmarks/simperf.py's scaled_testbed (the paper testbed,
# 2 zones of 2 x (2 vCPU / 2 GB) + 1 x (1 vCPU / 1 GB), replicated) at the
# decision rig's W of about 16384, behind benchmarks/coldstart.py's pool
TRACE_REPLICAS = 2731  # x 6 = 16,386 workers
TRACE_RATE = 4.0  # arrivals/s a replica (simperf: 192 over 48 replicas)
TRACE_TTL = 3.0
TRACE_BUDGET_MB = 512.0
TRACE_COSTS = {"cold": 0.5, "warm": 0.1, "hot": 0.0}
TRACE_SEED = 0
# run A: the poisson window is cut, never the rate or the cluster, to the
# shortest multiple of TRACE_STEP that holds TRACE_MIN_ARRIVALS arrivals;
# one zone dies and heals at BENCH_overload.json's 30/90 and 55/90 of it
TRACE_MIN_ARRIVALS = 4096
TRACE_STEP = 0.05
TRACE_ZONE = "us"
KILL_AT, HEAL_AT = 30.0 / 90.0, 55.0 / 90.0
TRACE_SLICE = 512  # the arrivals of run A's profiled slice
# run B: WAVE_TICKS ticks WAVE_DT apart of WAVE same-tick arrivals each
WAVE_TICKS = 64
WAVE_DT = 0.5
TRACE_RECORD_FIELDS = ("function", "worker", "t_submit", "latency",
                       "start_kind", "failed", "origin_zone", "arrival_id",
                       "t_root", "activation_id", "tenant", "attempts")


def scaled_testbed(k: int):
    """The paper's 6-worker / 2-zone layout replicated ``k`` times (a copy
    of ``benchmarks/simperf.py``'s, which imports the JAX package)."""
    out = {}
    for i in range(k):
        for spec in paper_testbed().values():
            name = f"{spec.name}r{i}"
            out[name] = WorkerSpec(name, spec.zone, spec.vcpus,
                                   spec.memory_mb)
    return out


def trace_sim(replicas: int) -> ClusterSim:
    """A fresh simulator over ``replicas`` testbed copies with a
    ``fixed_ttl`` warm pool and the scenario functions registered."""
    pool = WarmPool(make_policy("fixed_ttl", ttl=TRACE_TTL),
                    costs=StartCosts(**TRACE_COSTS),
                    budget_mb=TRACE_BUDGET_MB, hot_window=1.0)
    sim = ClusterSim(scaled_testbed(replicas), SimParams(), seed=TRACE_SEED,
                     pool=pool)
    register_functions(sim.registry)
    return sim


def poisson_window(replicas: int, min_arrivals: int = TRACE_MIN_ARRIVALS):
    """Run A's trace: the ``poisson`` scenario at TRACE_RATE a replica over
    the shortest window (a multiple of TRACE_STEP) holding
    ``min_arrivals`` arrivals.  Returns the window and the trace."""
    steps = 1
    while True:
        duration = round(steps * TRACE_STEP, 6)
        trace = build_trace("poisson", duration=duration,
                            rate=TRACE_RATE * replicas, seed=TRACE_SEED)
        if len(trace) >= min_arrivals:
            return duration, trace
        steps += 1


def wave_trace(ticks: int = WAVE_TICKS, per_tick: int = WAVE):
    """Run B's trace: ``ticks`` ticks WAVE_DT apart, each ``per_tick``
    same-tick arrivals drawn from the scenarios' root mix (api / thumb /
    etl by their arrival weights) with a seeded generator."""
    names = [n for n, (_m, _t, _c, wt) in FUNCTION_MIX.items()
             if wt > 0 and n != "divide"]
    weights = [FUNCTION_MIX[n][3] for n in names]
    mix = random.Random(TRACE_SEED + 7)
    return [Arrival(t=i * WAVE_DT, function=f) for i in range(ticks)
            for f in mix.choices(names, weights, k=per_tick)]


def records_equal(a, b) -> bool:
    """Record for record, every field and attribution component, NaN
    equal to NaN (``tests/test_bulk_wave.py``'s comparison)."""
    def feq(x, y):
        if isinstance(x, float) and isinstance(y, float):
            return x == y or (math.isnan(x) and math.isnan(y))
        return x == y

    if len(a) != len(b):
        return False
    for ra, rb in zip(a, b):
        if not all(feq(getattr(ra, k), getattr(rb, k))
                   for k in TRACE_RECORD_FIELDS):
            return False
        ca, cb = ra.components, rb.components
        if (ca is None) != (cb is None):
            return False
        if ca is not None and (ca.keys() != cb.keys() or not all(
                feq(ca[k], cb[k]) for k in ca)):
            return False
    return True


def traced_run(replicas: int, duration: float, trace, *, outage=True,
               **platform_kw):
    """Run A's set-up: a fresh simulator behind the port's Platform with
    the obs plane (tracer and stage timers) and an active resilience
    bundle with retry, the whatif script under ``best_first`` (``i``
    affine to ``d``), and (``outage``) the zone outage armed.  Returns the
    simulator and a callable that drives the trace and returns what the
    checks read."""
    sim = trace_sim(replicas)
    obs = Obs.enabled(timers=True)
    res = Resilience.enabled(retry=RetryPolicy())
    plat = Platform.for_sim(sim, build_script("best_first"), obs=obs,
                            resilience=res, **platform_kw)
    rng = random.Random(TRACE_SEED + 1)
    wl = TraceWorkload(sim, plat.placer(rng), COMPUTE_S, script=plat.script,
                       obs=obs, resilience=res)
    lost = []
    kill_zone = wl.fail_zone

    def fail_zone(zone):  # what the harness's kill loses, kept
        out = kill_zone(zone)
        lost.extend(out)
        return out

    wl.fail_zone = fail_zone
    harness = ChaosHarness([
        Fault(KILL_AT * duration, KILL_ZONE, TRACE_ZONE),
        Fault(HEAL_AT * duration, HEAL_ZONE, TRACE_ZONE)] if outage else [])
    harness.arm(wl)
    wl.load(trace)

    def drive():
        t0 = time.perf_counter()
        sim.run()
        wall = time.perf_counter() - t0
        run = RunResult(
            config=ReplayConfig("poisson", duration=duration,
                                rate=TRACE_RATE * replicas, seed=TRACE_SEED),
            trace=tuple(trace), records=tuple(wl.records),
            jsonl=obs.tracer.to_jsonl(),
            rng_tail=tuple(rng.random() for _ in range(4)), obs=obs,
            platform=plat)
        return {"run": run, "sim": sim, "res": res, "lost": lost,
                "chaos_log": list(harness.log), "wall_s": wall,
                "decisions": plat.session.stats["decisions"]}

    return sim, drive


def check_traced(out, twins) -> dict:
    """Run A's checks: records equal to each twin's (NaN-aware), rng tails
    equal, the tracer's jsonl byte-equal to the first twin's, the Chrome
    trace valid, work conserved per worker, the outage fired, and every
    activation the outage lost either retried or counted lost for good."""
    run, sim, res = out["run"], out["sim"], out["res"]
    for name, twin in twins.items():
        if not records_equal(run.records, twin["run"].records):
            raise AssertionError(f"run A's records differ from the {name} "
                                 "twin's")
        if run.rng_tail != twin["run"].rng_tail:
            raise AssertionError(f"run A's rng tail differs from the {name} "
                                 "twin's")
    first = next(iter(twins.values()))["run"]
    if run.jsonl != first.jsonl:
        raise AssertionError("run A's decision log differs from the "
                             f"{next(iter(twins))} twin's")
    errs = validate_chrome_trace(chrome_trace(run))
    if errs:
        raise AssertionError(f"run A's Chrome trace is invalid: {errs[:5]}")
    if sim.has_compute():
        raise AssertionError("run A left tasks running")
    for w in sim.workers:
        d, lw, s = (sim.delivered_work(w), sim.lost_work(w),
                    sim.submitted_work(w))
        if abs(d + lw - s) > 1e-6 * max(1.0, s):
            raise AssertionError(f"run A: worker {w} delivered {d} + lost "
                                 f"{lw} != submitted {s}")
    retries = res.ledger.total_retries
    if len(out["chaos_log"]) != 2 or not out["lost"]:
        raise AssertionError(f"run A's outage did not fire or lost nothing: "
                             f"{out['chaos_log']}, {len(out['lost'])} lost")
    if len(out["lost"]) != retries + res.permanent_lost:
        raise AssertionError(f"run A lost {len(out['lost'])} activations "
                             f"but retried {retries} and counted "
                             f"{res.permanent_lost} lost")
    return {"arrivals": len(run.trace), "records": len(run.records),
            "decisions": out["decisions"], "lost": len(out["lost"]),
            "retries": retries, "permanent_lost": res.permanent_lost,
            "jsonl_bytes": len(run.jsonl)}


def wave_run(replicas: int, trace, *, batched: bool, **platform_kw):
    """Run B: a fresh simulator behind an untraced Platform with no
    resilience bundle, ``best_first`` everywhere, and (``batched``) the
    wave batcher, so each same-tick group is one fused bulk decision.
    Returns the records, the rng tail, the wall seconds, the events and
    the session's wave counters."""
    sim = trace_sim(replicas)
    plat = Platform.for_sim(sim, build_script("best_first"), **platform_kw)
    rng = random.Random(TRACE_SEED + 1)
    wl = TraceWorkload(sim, plat.placer(rng), COMPUTE_S, script=plat.script,
                       batcher=plat.batch_placer(rng) if batched else None)
    wl.load(trace)
    t0 = time.perf_counter()
    sim.run()
    wall = time.perf_counter() - t0
    flat = getattr(plat.session, "flat", plat.session)
    return {"records": list(wl.records),
            "rng_tail": tuple(rng.random() for _ in range(4)),
            "wall_s": wall, "events": sim.stats["events"],
            "bulk_waves": flat.stats["bulk_waves"],
            "bulk_fallback": flat.stats["bulk_fallback"]}


def stage_timers(obs) -> dict:
    """The obs stage-timer histograms (host perf_counter seconds, sampled
    1 in 128 decisions) as the registry snapshots them."""
    snap = obs.snapshot()
    return {k: v for k, v in snap.items() if k.startswith("sched.stage.")}


def slice_idle_share(replicas: int, duration: float, trace,
                     device="cuda") -> dict:
    """Run A's first arrivals, at most TRACE_SLICE of them and all before
    its outage (so decided on the same state as in run A), again under
    ``torch.profiler``, from the start of the run to the last of them: the
    host wall time, the device time summed over every kernel and copy, and
    the device's idle share (1 - device / wall; one stream, so kernels do
    not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = min(TRACE_SLICE,
            sum(a.t < KILL_AT * duration for a in trace))
    last = trace[n - 1].t
    sim, drive = traced_run(replicas, duration, trace[:n], outage=False,
                            device=device)
    prof = profile(activities=[ProfilerActivity.CUDA])
    span = {}

    def stop():  # after the last arrival's decision (its event is earlier)
        torch.cuda.synchronize()
        span["wall_ms"] = (time.perf_counter() - span["t0"]) * 1e3
        prof.stop()

    sim.at(last, stop)
    torch.cuda.synchronize()
    prof.start()
    span["t0"] = time.perf_counter()
    drive()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    return {"arrivals": n, "wall_ms": span["wall_ms"],
            "device_ms": busy, "idle_share": 1.0 - busy / span["wall_ms"]}


def trace_path(replicas: int = TRACE_REPLICAS, device="cuda", *,
               min_arrivals: int = TRACE_MIN_ARRIVALS,
               ticks: int = WAVE_TICKS, per_tick: int = WAVE) -> dict:
    """Phase 12: runs A and B on ``replicas`` testbed copies, each held to
    its twins (``device="cpu"``: the kernels' plain versions; the float64
    ``backend="np"``), with the launch counters reset just before the run
    on ``device`` and read just after.  On the card, one slice of run A is
    run again under the profiler.  Returns the numbers printed."""
    workers = 6 * replicas
    duration, trace = poisson_window(replicas, min_arrivals)
    on_card = torch.device(device).type == "cuda"

    # run A: per arrival, traced, with resilience and an outage
    _sim, drive = traced_run(replicas, duration, trace, device=device)
    for k in KERNELS:
        k.launches = 0
    a = drive()
    a_launches = {k.name: k.launches for k in KERNELS}
    twins = {"cpu": traced_run(replicas, duration, trace, device="cpu")[1](),
             "np": traced_run(replicas, duration, trace, backend="np")[1]()}
    a_checks = check_traced(a, twins)
    if on_card and not a_launches["affinity_valid"] > 0:
        raise AssertionError(f"run A launched no affinity_valid: "
                             f"{a_launches}")
    a_out = {"workers": workers, "window_s": duration,
             "rate_per_s": TRACE_RATE * replicas, **a_checks,
             "chaos_log": a["chaos_log"],
             "wall_s": a["wall_s"], "events": a["sim"].stats["events"],
             "events_per_s": a["sim"].stats["events"] / a["wall_s"],
             "us_per_decision": a["wall_s"] / a["decisions"] * 1e6,
             "np_twin_wall_s": twins["np"]["wall_s"],
             "np_twin_us_per_decision":
                 twins["np"]["wall_s"] / twins["np"]["decisions"] * 1e6,
             "cpu_twin_wall_s": twins["cpu"]["wall_s"],
             "launches": a_launches,
             "stage_timers_host_s": stage_timers(a["run"].obs),
             "reduced": {"window_s": duration,
                         "why": f"the shortest multiple of {TRACE_STEP} s "
                                f"holding {min_arrivals} arrivals at the "
                                "full rate and cluster"}}
    if on_card:
        a_out["slice"] = slice_idle_share(replicas, duration, trace, device)

    # run B: same-tick waves through the fused bulk pass, untraced
    waves = wave_trace(ticks, per_tick)
    for k in KERNELS:
        k.launches = 0
    b = wave_run(replicas, waves, batched=True, device=device)
    b_launches = {k.name: k.launches for k in KERNELS}
    seq = wave_run(replicas, waves, batched=False, device=device)
    cpu = wave_run(replicas, waves, batched=True, device="cpu")
    twin = wave_run(replicas, waves, batched=True, backend="np")
    for name, other in (("one arrival at a time", seq), ("cpu", cpu),
                        ("np", twin)):
        if not records_equal(b["records"], other["records"]) \
                or b["rng_tail"] != other["rng_tail"]:
            raise AssertionError(f"run B's records differ from the {name} "
                                 "run's")
    # every tick is one wave (WAVE same-tick arrivals) of best_first
    # wildcard blocks: decide_wave's one fused pass a wave, no per-item
    # fallback, and no rebuild (nothing completes or churns mid-wave)
    if b["bulk_waves"] != ticks or b["bulk_fallback"]:
        raise AssertionError(f"run B: {b['bulk_waves']} waves, "
                             f"{b['bulk_fallback']} fell back")
    if on_card and b_launches != {"affinity_valid": 0,
                                  "bulk_decide": ticks}:
        raise AssertionError(f"run B launched {b_launches}, expected one "
                             f"bulk_decide a wave ({ticks})")
    n = len(waves)
    b_out = {"workers": workers, "ticks": ticks, "wave": per_tick,
             "arrivals": n, "records": len(b["records"]),
             "wall_s": b["wall_s"], "events": b["events"],
             "events_per_s": b["events"] / b["wall_s"],
             "us_per_wave_decision": b["wall_s"] / n * 1e6,
             "sequential_wall_s": seq["wall_s"],
             "sequential_us_per_decision": seq["wall_s"] / n * 1e6,
             "np_twin_wall_s": twin["wall_s"],
             "np_twin_us_per_wave_decision": twin["wall_s"] / n * 1e6,
             "cpu_wall_s": cpu["wall_s"], "launches": b_launches}
    return {"A": a_out, "B": b_out}


# --------------------------------------------------------------------------- #


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Drive the port on one card.")
    ap.add_argument("--baseline-scan", type=Path, default=None,
                    help="an earlier selective_scan.cu (same C entry point) "
                    "to build and time beside this one in phase 11")
    ap.add_argument("--baseline-affinity", type=Path, default=None,
                    help="a directory with the parent commit's "
                    "affinity_valid.cu, bulk_decide.cu and "
                    "affinity_common.cuh, to build and time beside these "
                    "in phase 5")
    args = ap.parse_args(argv)
    # 1. card
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's smoke run needs "
              "an NVIDIA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    tag = f"[{card}]"
    print(f"card: {card} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda})", flush=True)

    # float32 products in full float32 (the defaults, stated): the float32
    # checks below compare paths, not TF32 roundings
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build, from the sources in this checkout
    for k in ALL_KERNELS:
        k.library_path().unlink(missing_ok=True)
    build_s = build_all(ALL_KERNELS)
    ptxas = {k.name: ptxas_summary(k.build_log) for k in ALL_KERNELS}
    spilled = [name for name, p in ptxas.items() if p["spill_bytes"]]
    if spilled:
        raise AssertionError(f"kernels spill registers: {ptxas}")
    print(f"build: {', '.join(k.name for k in ALL_KERNELS)} built in "
          f"{build_s:.2f} s (nvcc, sm_90a, in parallel); -Xptxas -v "
          f"registers per instance and spilled bytes: {ptxas}", flush=True)

    # 3. kernels vs plain, bit for bit
    shapes = AFFINITY_CASES
    errs = {"affinity_valid": 0.0, "bulk_decide": 0.0}
    for W, T, R in shapes:
        errs = worst(errs, compare_kernel_case(
            kernel_case(W, T, R, seed=W * 31 + T * 7 + R)))
    print(f"kernels vs plain: bit-exact on valid, score and winner (max abs "
          f"err {errs}) at (W, T, R) = {shapes}, with all-tied and "
          "all-invalid rows", flush=True)
    flash_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    bf16_cases = []
    for i, (B, Sq, Skv, H, K, hd, causal, window) in enumerate(FLASH_CASES):
        for dtype in flash_err:
            q, k, v = flash_inputs(B, Sq, Skv, H, K, hd, dtype, seed=i)
            err, checks = compare_flash(q, k, v, causal, window)
            flash_err[dtype] = max(flash_err[dtype], err)
            if checks is not None:
                bf16_cases.append([[c[key] for key in BF16_KEYS]
                                   for c in checks.values()])
    print(f"flash_attention vs plain: float32 kernel max abs err "
          f"{flash_err[torch.float32]} (tolerance {FLASH_TOL[torch.float32]});"
          f" bf16 kernel per element within tolerance against the inputs "
          f"widened to float32, per case [whole inputs, v on a late key "
          f"tile], each {list(BF16_KEYS)} (dropped tile at least "
          f"{FLASH_DROP} x tolerance) {bf16_cases}, at (B, Sq, Skv, H, K, hd,"
          f" causal, window) = {FLASH_CASES}", flush=True)
    scan_err = 0.0
    for i, (B, S, D, N, dtype) in enumerate(SCAN_CASES):
        scan_err = max(scan_err, compare_scan(
            *scan_inputs(B, S, D, N, dtype, seed=100 + i))[0])
    print(f"selective_scan vs plain: max abs err {scan_err} (tolerance "
          f"{SCAN_TOL}) at (B, S, D, N, dtype) = {SCAN_CASES}", flush=True)
    long_err, long_tol, long_ratio = scan_long_memory_check(seed=99)
    scan_err = max(scan_err, long_err)
    print(f"selective_scan vs plain, long memory (a = -{SCAN_LONG_A} "
          f"exp(normal), (B, S, D, N) = {SCAN_LONG}, dt f32, x/b/c bf16): "
          f"max abs err {long_err} (tolerance {long_tol}); the plain version "
          f"with the state reset at step {SCAN_CUT} moves y by {long_ratio} x "
          f"that tolerance (at least {SCAN_CARRY})", flush=True)

    # 4. the decision path at full size, held to the float64 twin
    plat = build_rig(WORKERS)  # device="cuda", the default
    for f in FUNCTIONS:  # first-launch and cache warm-up, outside the count
        plat.decide(f, rng=random.Random(0))
    for k in KERNELS:
        k.launches = 0
    got, secs = drive_main_path(plat)
    launches = {k.name: k.launches for k in KERNELS}
    want, twin_secs = drive_main_path(build_rig(WORKERS, backend="np"))
    if got != want:
        raise AssertionError("main-path decisions differ from the float64 "
                             "np twin")
    placed = sum(w is not None for w in got["arrivals"])
    if placed == 0 or not all(n > 0 for n in launches.values()):
        raise AssertionError(f"main path did not run its kernels: "
                             f"{launches}, {placed} placed")
    print(f"main path: W={WORKERS}, {WAVE} decide() + {N_WAVES} waves of "
          f"{WAVE} (apply=False) + 1 applied wave; decisions equal the np "
          f"twin ({placed}/{WAVE} arrivals placed); launches {launches}",
          flush=True)

    # ... and each kernel against its plain version, bit for bit, on the
    # inputs the main path gives it: every function's per-arrival rows and
    # a wave's rows, from the session's live state
    arrivals, wave_case = main_path_inputs(plat)
    for case in (*arrivals.values(), wave_case):
        errs = worst(errs, compare_on_card(case)[0])
    arrival_case = arrivals["f_lat"]
    print(f"kernels vs plain at the main path's inputs: bit-exact (max abs "
          f"err {errs}) at (F, W, T) = "
          f"{sorted({(len(a[1]), *a[0].shape) for a in arrivals.values()})} "
          f"(affinity_valid, per arrival) and (R, W, T) = "
          f"{(len(wave_case[1]), *wave_case[0].shape)} (both kernels, per "
          "wave)", flush=True)

    # 5. times: each kernel at its main-path shape, then at the 512-tag
    # scale serve.Engine lets the tag axis reach (a full wave of 512 rows)
    scale = kernel_case(WORKERS, 512, 512, seed=5)
    timed = {
        ("affinity_valid", "main"): time_kernel("affinity_valid",
                                                arrival_case),
        ("bulk_decide", "main"): time_kernel("bulk_decide", wave_case),
        ("affinity_valid", "T512"): time_kernel(
            "affinity_valid", first_rows(scale, len(arrival_case[1]))),
        ("bulk_decide", "T512"): time_kernel("bulk_decide", scale)}
    for (name, where), t in timed.items():
        print(f"time {tag}: {name} at {tuple(t['shape'])} ({where}): "
              f"{json.dumps(t)}", flush=True)
    for name, case in (("affinity_valid", arrival_case),
                       ("bulk_decide", wave_case)):
        print(f"call split {tag}: {name} at the main path's shape: "
              f"{json.dumps(affinity_call_split(name, case))}", flush=True)
    if args.baseline_affinity is not None:
        base = time_affinity_baseline(args.baseline_affinity, {
            f"{name}_{where}": (name, case) for (name, where), case in (
                (("affinity_valid", "main"), arrival_case),
                (("bulk_decide", "main"), wave_case),
                (("affinity_valid", "T512"),
                 first_rows(scale, len(arrival_case[1]))),
                (("bulk_decide", "T512"), scale))})
        print(f"baseline {tag}: the parent's affinity kernels "
              f"({args.baseline_affinity}) and these, in turns: "
              f"{json.dumps(base)}", flush=True)
    valid_on_card = affinity_valid(*on_card(arrival_case)[0])
    e2e = {"us_per_decision_arrival": secs["arrival_s"] / WAVE * 1e6,
           "us_per_decision_wave512": secs["wave_s"] / WAVE * 1e6,
           "us_per_decision_applied_wave512":
               secs["applied_wave_s"] / WAVE * 1e6,
           # where an arrival's time goes: the numpy-in/numpy-out valid
           # call the session makes, and two of its parts: the inputs'
           # conversion and host->device copies, and the copy back ...
           "us_affinity_valid_np_call": 1e3 * host_ms(
               lambda: affinity_valid_np(*arrival_case)),
           "us_arrival_inputs_to_card": 1e3 * host_ms(
               lambda: (as_inputs(*arrival_case, torch.device("cuda")),
                        torch.cuda.synchronize())),
           "us_arrival_valid_to_host": 1e3 * host_ms(
               lambda: valid_on_card.cpu().numpy()),
           # ... and the float64 host twin on this host, for scale
           "np_twin_us_per_decision_arrival":
               twin_secs["arrival_s"] / WAVE * 1e6,
           "np_twin_us_per_decision_wave512":
               twin_secs["wave_s"] / WAVE * 1e6}
    print(f"end to end {tag}: {json.dumps(e2e)}", flush=True)

    # 6. the serving path: gemma3-4b whole behind serve.Engine
    cfg = GEMMA3_4B
    serve_launches, main_err, main_f32, serving = serving_path(cfg)

    # 7. one period of the model at full width in float32: flash vs direct
    f32_err, f32_scale, f32_launches = whole_model_f32(cfg)
    print(f"whole model, float32: gemma3-4b with n_layers=6 (one 5:1 "
          f"local:global period, full width), S = 2048; prefill logits via "
          f"flash vs direct: max abs err {f32_err} (bound {MODEL_F32_TOL}; "
          f"largest |logit| {f32_scale}); {f32_launches} flash launches",
          flush=True)

    # 8. serving times
    flash_t = {(dtype, name): time_flash(dtype, window, seed=seed)
               for dtype in (torch.bfloat16, torch.float32)
               for name, window, seed in (("causal", None, 11),
                                          ("window1024", cfg.sliding_window,
                                           12))}
    for (dtype, name), t in flash_t.items():
        kern = fa.choose_kernel(dtype, t["shape"][-1]).name
        print(f"time {tag}: {kern} {name} at {tuple(t['shape'])} "
              f"{t['dtype']}: {json.dumps(t)}", flush=True)
    print(f"serving end to end {tag}: {json.dumps(serving)}", flush=True)

    # 9. the SSM serving path: gemma3-4b's weights freed, falcon-mamba-7b
    # whole behind the same engine and deployment
    gc.collect()
    torch.cuda.empty_cache()
    print(f"device memory before falcon-mamba-7b: "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated",
          flush=True)
    ssm_cfg = FALCON_MAMBA_7B
    ssm_launches, scan_live_err, ssm_serving = ssm_serving_path(ssm_cfg)
    gc.collect()
    torch.cuda.empty_cache()

    # 10. the SSM model at full width in float32: kernel vs plain scan
    s32_err, s32_scale, s32_launches = ssm_model_f32(ssm_cfg)
    print(f"whole model, float32: falcon-mamba-7b with n_layers="
          f"{SSM_F32_LAYERS} (full width), S = {F32_PROMPT}; logits at every "
          f"position via the scan kernel vs backend='ref': max abs err "
          f"{s32_err} (bound {SCAN_TOL} x max(1, {s32_scale})); "
          f"{s32_launches} scan launches", flush=True)

    # 11. SSM times (and, when asked, an earlier scan kernel's beside them)
    baseline = None
    if args.baseline_scan is not None:
        k = ms.SELECTIVE_SCAN_KERNEL
        baseline = type(k)("selective_scan_baseline",
                           str(args.baseline_scan.resolve()), entry=k.entry,
                           argtypes=k.argtypes, flags=k.flags)
        baseline.library_path().unlink(missing_ok=True)
    scan_t = time_scan(seed=14, baseline=baseline)
    scan_t["registers"] = ptxas["selective_scan"]
    print(f"time {tag}: selective_scan at {tuple(scan_t['shape'])} "
          f"({scan_t['types']}): {json.dumps(scan_t)}", flush=True)
    print(f"SSM serving end to end {tag}: {json.dumps(ssm_serving)}",
          flush=True)

    # 12. the trace-driven decision path at 16,386 workers
    trace = trace_path()
    for run in ("A", "B"):
        print(f"trace path {tag}: run {run}: {json.dumps(trace[run])}",
              flush=True)

    rows = []
    for k in KERNELS:
        name = k.name
        t = timed[(name, "main")]
        rows.append({"name": name, "route": "cuda",
                     "source": str(k.source.relative_to(ROOT)),
                     "replaces": REPLACES[name], "launches": launches[name],
                     "max_abs_err": errs[name], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": None,
                     "device_ms": t["device_ms"], "shape": t["shape"],
                     "trace_path_launches": {
                         run: trace[run]["launches"][name]
                         for run in ("A", "B")}})
    # the bf16 kernel's launches are the serving run's; the float32
    # kernel's are phase 7's (the float32 period: no bf16 path runs it)
    for k, dtype, n, err in (
            (fa.FLASH_ATTENTION_BF16_KERNEL, torch.bfloat16,
             serve_launches["flash_attention_bf16"],
             max(flash_err[torch.bfloat16], *main_err.values())),
            (fa.FLASH_ATTENTION_KERNEL, torch.float32, f32_launches,
             max(flash_err[torch.float32], *main_f32.values()))):
        t = flash_t[(dtype, "causal")]
        rows.append({"name": k.name, "route": "cuda",
                     "source": str(k.source.relative_to(ROOT)),
                     "replaces": REPLACES[k.name], "launches": n,
                     "max_abs_err": err, "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"],
                     "device_ms": t["device_ms"],
                     "library_device_ms": t["library_device_ms"],
                     "shape": t["shape"],
                     "dtype": t["dtype"], "window1024": {
                         key: flash_t[(dtype, "window1024")][key]
                         for key in ("ms", "device_ms", "plain_ms",
                                     "library_ms", "library_device_ms",
                                     "bound_ms", "bound_by")}})
    k = ms.SELECTIVE_SCAN_KERNEL
    rows.append({"name": k.name, "route": "cuda",
                 "source": str(k.source.relative_to(ROOT)),
                 "replaces": REPLACES[k.name],
                 "launches": ssm_launches[k.name],
                 "max_abs_err": max(scan_err, scan_live_err),
                 "ms": scan_t["ms"], "plain_ms": scan_t["plain_ms"],
                 "bound_ms": scan_t["bound_ms"],
                 "bound_by": scan_t["bound_by"], "library_ms": None,
                 "device_ms": scan_t["device_ms"],
                 "shape": scan_t["shape"]})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
