#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each (every time beside the card's name and power limit):

1. card   — ``nvidia-smi`` name and power limit; fails without CUDA;
2. build  — the three kernels from ``src/repro_torch/kernels/*/csrc/*.cu``
   with ``nvcc``, one process per source, in parallel;
3. kernels vs plain — each affinity kernel against its plain PyTorch version
   on the card, bit for bit, at tile-edge shapes and at the main path's
   shapes, with rows that are all tied (the lowest index must win) and rows
   with no valid worker (``-1``); the flash-attention kernel against its
   plain version in float32 (within 2e-5) and bfloat16 (within 5e-2) at
   ragged lengths, Sq != Skv, GQA ratios 1, 2, 4, head dims 64, 128, 256,
   window 1 and a window past the sequence, causal with a window at
   Sq != Skv;
4. decision path — the port's ``Platform`` on the reference scheduler-scale rig
   (16384 workers of 64 MB, 50% pre-occupied, 5% sparse warm residency):
   512 ``decide()`` calls, ``decide_batch`` waves of 512 with
   ``apply=False``, one ``apply=True`` wave.  The decisions must equal the
   same run on the float64 ``backend="np"`` twin, and both kernels' launch
   counters must have moved.  Then each kernel against its plain version
   on the card, bit for bit, on the inputs the main path gives it (every
   function's per-arrival rows, a wave's rows) from the live session;
5. times — each affinity kernel's CUDA-event time at the main path's shapes
   and at the 512-tag, 512-row scale, its profiler device time, its plain
   version's times, and its bound; end-to-end us/decision per arrival and
   per wave of 512, beside the float64 host twin's on the same host, and
   the per-arrival valid call with two of its parts (inputs to the card,
   the result back to the host);
6. serving path — gemma3-4b whole (34 layers, bf16, weights drawn on the card
   from a seeded generator) behind the port's ``serve.Engine`` on
   ``two_pod_cells()``: 4 sessions' prefills of 4096 seeded tokens through
   the flash kernel, 32 decodes, one cell failed mid-run (its sessions are
   re-prefilled elsewhere).  Every completion must be ok, every decode on
   its session's cell, every logit finite; the flash counter must move by
   exactly 34 per prefill and ``affinity_valid``'s must move.  Then the
   flash kernel against its plain version on the q / k / v of the first
   local and the first global layer, captured from the live prefill, in
   bf16 and widened to float32 (at the float32 tolerance);
7. whole model in float32 — one local:global period of gemma3-4b at full
   width (6 layers), S = 2048: prefill logits through the flash kernel
   against the direct path on the card;
8. serving times — the flash kernel at (1, 4096, 8, 4, 256) bf16, causal and
   window 1024 (CUDA-event and profiler ms, plain ms,
   ``scaled_dot_product_attention`` ms, bound); prefill ms and tokens/s,
   decode ms per token and the engine's scheduling us per request; where
   one prefill's and one decode step's time goes on the card (profiler:
   flash, matrix products, the rest, and the device's idle share);

then a ``{"kernels": [...]}`` line, the card line, and the result line
``{"ok": true, "device": {...}}``.  Any failed phase raises: the script
exits non-zero and prints no result line.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import random
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

from repro_torch.cluster.topology import two_pod_cells  # noqa: E402
from repro_torch.configs.registry import GEMMA3_4B  # noqa: E402
from repro_torch.core.ast import (AAppScript, Affinity, Block,  # noqa: E402
                                  Invalidate, TagPolicy)
from repro_torch.core.state import ClusterState, Registry  # noqa: E402
from repro_torch.kernels.affinity import (KERNELS, NO_CAP,  # noqa: E402
                                          NO_CONC, affinity_valid,
                                          affinity_valid_np, bulk_decide)
from repro_torch.kernels.affinity.bulk_ref import bulk_decide_ref  # noqa: E402
from repro_torch.kernels.affinity.ops import as_inputs  # noqa: E402
from repro_torch.kernels.affinity.ref import affinity_valid_ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.build import build_all  # noqa: E402
from repro_torch.models import (init_cache, init_model,  # noqa: E402
                                model_decode_step)
from repro_torch.platform import Platform  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from repro_torch.train.step import make_prefill_step  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, at the full 700 W limit)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12

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

# the TPU kernel each CUDA kernel replaces (its Pallas body in the JAX package)
REPLACES = {"affinity_valid": "src/repro/kernels/affinity/kernel.py:33",
            "bulk_decide": "src/repro/kernels/affinity/bulk_kernel.py:31",
            "flash_attention":
                "src/repro/kernels/flash_attention/kernel.py:27"}
ALL_KERNELS = (*KERNELS, *fa.KERNELS)

# the serving path (launch/serve.py's deployment, gemma3-4b at full size)
PROMPT = 4096
SESSIONS = 4
DECODES = 32
FAIL_AT = 16  # the decode before which session s0's cell fails
MAX_LEN = PROMPT + 64
DEPLOY = ["pod0-cell0", "pod0-cell1", "pod1-cell0"]
# flash kernel vs plain: float32 and bfloat16 tolerances of
# tests/test_kernels.py; the float32 whole-model check's bound on logits
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2}
MODEL_F32_TOL = 1e-2
F32_PROMPT = 2048


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


def device_ms(fn, iters: int = 50):
    """Device time per call, summed over every CUDA kernel and copy the call
    enqueued, from ``torch.profiler``; ``None`` when the profiler sees no
    device activity (then the device time is not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / iters / 1e3 if us > 0 else None


def time_kernel(name: str, case):
    """The kernel's wrapper and its plain version on the same card inputs:
    CUDA-event ms per call (the wrapper's host work included), profiler
    device ms per call, and the bound.  ``case`` has 9 arrays for
    ``affinity_valid`` and 11 (with strat, warm) for ``bulk_decide``."""
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
    return {"shape": [F, W, T], "ms": cuda_ms(kern),
            "plain_ms": cuda_ms(plain), "device_ms": device_ms(kern),
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


def compare_flash(q, k, v, causal, window) -> float:
    """The flash kernel against its plain version on the same card inputs;
    raises past the dtype's tolerance, returns the largest difference."""
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError("flash_attention returned another dtype or "
                             "shape than its plain version")
    err = max_abs_err(got.float(), want.float())
    if not err <= FLASH_TOL[q.dtype]:
        raise AssertionError(
            f"flash_attention differs from its plain version by {err} at "
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype}, "
            f"causal={causal}, window={window}")
    return err


def gemma_prompt(session: str, vocab: int) -> torch.Tensor:
    """A seeded prompt of PROMPT token ids for one session."""
    g = torch.Generator(device="cuda").manual_seed(100 + int(session[1:]))
    return torch.randint(0, vocab, (1, PROMPT), generator=g, device="cuda")


class ServeRunner:
    """The runner ``launch/serve.py`` gives the engine, on the full model: a
    prefill runs the flash prefill step on the session's prompt and makes an
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
            tokens = gemma_prompt(req.session, self.cfg.vocab)
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


def device_breakdown(fn, iters: int = 3):
    """Where one call's time goes on the card: ``torch.profiler`` over
    ``iters`` calls after one warm-up, the device time summed by kernel
    name into the flash kernel, matrix products (cuBLAS / CUTLASS kernel
    names) and the rest, beside the host wall time of the same calls under
    the profiler; idle share = 1 - device time / wall time.  Kernels of one
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
    flash = sum(v for k, v in by_name.items() if "flash_fwd" in k)
    matmul = sum(v for k, v in by_name.items() if "flash_fwd" not in k and
                 any(m in k.lower() for m in ("gemm", "nvjet", "xmma",
                                              "cutlass")))
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"wall_ms": wall_ms, "device_ms": busy,
            "idle_share": 1.0 - busy / wall_ms, "flash_ms": flash,
            "matmul_ms": matmul, "other_ms": busy - flash - matmul,
            "kernels": len(by_name),
            "top": [[k[:80], v] for k, v in top]}


def whole_model_f32(base):
    """One local:global period of ``base`` (gemma3-4b) at full width in
    float32: the prefill's logits through the flash kernel against the
    direct path, on the same card and weights.  Returns the largest
    difference, the largest logit and the flash launches of the flash
    prefill."""
    cfg = dataclasses.replace(base, n_layers=base.period, dtype="float32")
    model = init_model(cfg, torch.Generator(device="cuda").manual_seed(1))
    g = torch.Generator(device="cuda").manual_seed(6)
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, F32_PROMPT), generator=g,
                                     device="cuda")}
    fa.FLASH_ATTENTION_KERNEL.launches = 0
    flash = make_prefill_step(cfg, impl="flash")(model, batch)
    launches = fa.FLASH_ATTENTION_KERNEL.launches
    direct = make_prefill_step(cfg, impl="direct")(model, batch)
    torch.cuda.synchronize()
    err = max_abs_err(flash, direct)
    if not err <= MODEL_F32_TOL or launches != cfg.n_layers:
        raise AssertionError(f"float32 gemma3-4b period: flash vs direct "
                             f"logits differ by {err} (bound "
                             f"{MODEL_F32_TOL}), {launches} flash launches")
    return err, float(direct.abs().max()), launches


def masked_pairs(S: int, window) -> int:
    """(query, key) pairs a causal mask (with ``window``) admits at
    Sq = Skv = S."""
    if window is None:
        return S * (S + 1) // 2
    return sum(min(i + 1, window) for i in range(S))


def time_flash(window, seed: int):
    """The flash kernel at the serving path's shape (1, 4096, 8, 4, 256)
    bf16, causal with ``window``: CUDA-event ms per call, profiler device
    ms, the plain version's ms, ``scaled_dot_product_attention``'s ms on
    the same inputs (causal with ``enable_gqa``; the window as an explicit
    mask) and the bound: the larger of every input read once and the
    output written once over HBM, and the mask's useful multiply-adds
    (q k^T and p v, 4 hd flops per admitted pair and head) at the dense
    bf16 tensor rate."""
    import torch.nn.functional as F

    B, S, H, K, hd = 1, PROMPT, 8, 4, 256
    q, k, v = flash_inputs(B, S, S, H, K, hd, torch.bfloat16, seed)
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
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    flops = 4 * hd * H * masked_pairs(S, window)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return {"shape": [B, S, H, K, hd], "window": window,
            "ms": cuda_ms(kern, iters=50, warmup=5),
            "device_ms": device_ms(kern, iters=20),
            "plain_ms": cuda_ms(plain, iters=10, warmup=2),
            "library_ms": cuda_ms(lib, iters=50, warmup=5),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "useful_gflop": flops / 1e9, "mbytes": nbytes / 1e6}

def serving_path(cfg):
    """Phase 6: ``cfg`` whole behind ``serve.Engine`` with every launch
    counter set to 0 just before and read just after, the run's checks, and
    the flash kernel held to its plain version on the q / k / v the run
    captured.  Returns the launches, those comparisons' errors and the
    run's end-to-end numbers."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    capture = FlashCapture()
    fa.flash_attention = capture
    for k in ALL_KERNELS:
        k.launches = 0
    try:
        eng, runner, sched_us, victim, moved, stayed = drive_serving(cfg,
                                                                     model)
    finally:
        fa.flash_attention = capture.kernel
    serve_launches = {k.name: k.launches for k in ALL_KERNELS}
    n_prefills = len(runner.prefill_s)
    bad = [c for c in eng.completions if not c.ok]
    if bad or not stayed or not runner.finite:
        raise AssertionError(f"serving path: {len(bad)} failed completions,"
                             f" decodes on their session's cell: {stayed}, "
                             f"logits finite: {runner.finite}")
    if not moved or victim is None or n_prefills != SESSIONS + len(moved):
        raise AssertionError(f"serving path: failing {victim} moved {moved};"
                             f" {n_prefills} prefills ran")
    if serve_launches["flash_attention"] != cfg.n_layers * n_prefills or \
            serve_launches["affinity_valid"] == 0:
        raise AssertionError(f"serving path launches {serve_launches} for "
                             f"{n_prefills} prefills of {cfg.n_layers} "
                             "layers")
    print(f"serving path: {cfg.name} whole ({cfg.n_layers} layers, "
          f"{n_params / 1e9:.3f} B parameters, bf16, drawn on the card in "
          f"{init_s:.2f} s) behind serve.Engine on {len(two_pod_cells())} "
          f"cells; {SESSIONS} prefills of {PROMPT} tokens, {DECODES} decodes"
          f", cell {victim} failed before decode {FAIL_AT} (re-prefilled "
          f"{moved}); {len(eng.completions)} completions ok, decodes on "
          f"their session's cell, logits finite; launches {serve_launches} "
          f"({n_prefills} prefills x {cfg.n_layers})", flush=True)
    # the outputs are softmax means of v over up to 4096 keys, far smaller
    # than the bf16 tolerance: the same inputs widened to float32 are held
    # at the float32 tolerance, and the outputs' median size is printed
    main_err, main_err_f32, median_out = {}, {}, {}
    for kind in ("local", "global"):
        q, k, v, causal, window = capture.seen[kind]
        main_err[kind] = compare_flash(q, k, v, causal, window)
        q, k, v = (t.float() for t in (q, k, v))
        main_err_f32[kind] = compare_flash(q, k, v, causal, window)
        median_out[kind] = float(fa.flash_attention_ref(
            q, k, v, causal=causal, window=window).abs().median())
    print(f"flash_attention vs plain at the serving path's inputs (the first"
          f" local and global layer of the first prefill, "
          f"{tuple(capture.seen['local'][0].shape)}): max abs err {main_err} "
          f"in bf16 (tolerance {FLASH_TOL[torch.bfloat16]}), {main_err_f32} "
          f"on the same inputs in float32 (tolerance "
          f"{FLASH_TOL[torch.float32]}); median |output| {median_out}",
          flush=True)
    # where a prefill's and a decode step's time goes on the card
    tokens = gemma_prompt("s0", cfg.vocab)
    prefill = make_prefill_step(cfg, impl="flash")
    state = {"cache": init_cache(cfg, 1, MAX_LEN)}
    tok = tokens[:, -1:]

    def decode():
        with torch.no_grad():
            _, state["cache"] = model_decode_step(cfg, model, state["cache"],
                                                  tok)

    breakdown = {"prefill": device_breakdown(
                     lambda: prefill(model, {"tokens": tokens})),
                 "decode": device_breakdown(decode, iters=8)}
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
        "flash_vs_plain_main_path": {"bf16": main_err, "float32": main_err_f32,
                                     "median_abs_output": median_out},
        "breakdown": breakdown}
    return serve_launches, main_err, serving



# --------------------------------------------------------------------------- #


def main() -> int:
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
    print(f"build: {', '.join(k.name for k in ALL_KERNELS)} built in "
          f"{build_s:.2f} s (nvcc, sm_90a, in parallel)", flush=True)

    # 3. kernels vs plain, bit for bit
    shapes = [(1, 1, 1), (130, 5, 257), (16385, 3, 129), (16384, 4, 3),
              (16384, 512, 512)]
    errs = {"affinity_valid": 0.0, "bulk_decide": 0.0}
    for W, T, R in shapes:
        errs = worst(errs, compare_kernel_case(
            kernel_case(W, T, R, seed=W * 31 + T * 7 + R)))
    print(f"kernels vs plain: bit-exact on valid, score and winner (max abs "
          f"err {errs}) at (W, T, R) = {shapes}, with all-tied and "
          "all-invalid rows", flush=True)
    flash_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for i, (B, Sq, Skv, H, K, hd, causal, window) in enumerate(FLASH_CASES):
        for dtype in flash_err:
            q, k, v = flash_inputs(B, Sq, Skv, H, K, hd, dtype, seed=i)
            flash_err[dtype] = max(flash_err[dtype],
                                   compare_flash(q, k, v, causal, window))
    print(f"flash_attention vs plain: max abs err {flash_err[torch.float32]}"
          f" in float32 (tolerance {FLASH_TOL[torch.float32]}), "
          f"{flash_err[torch.bfloat16]} in bfloat16 (tolerance "
          f"{FLASH_TOL[torch.bfloat16]}) at (B, Sq, Skv, H, K, hd, causal, "
          f"window) = {FLASH_CASES}", flush=True)

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
    serve_launches, main_err, serving = serving_path(cfg)

    # 7. one period of the model at full width in float32: flash vs direct
    f32_err, f32_scale, f32_launches = whole_model_f32(cfg)
    print(f"whole model, float32: gemma3-4b with n_layers=6 (one 5:1 "
          f"local:global period, full width), S = 2048; prefill logits via "
          f"flash vs direct: max abs err {f32_err} (bound {MODEL_F32_TOL}; "
          f"largest |logit| {f32_scale}); {f32_launches} flash launches",
          flush=True)

    # 8. serving times
    flash_t = {"causal": time_flash(None, seed=11),
               "window1024": time_flash(cfg.sliding_window, seed=12)}
    for name, t in flash_t.items():
        print(f"time {tag}: flash_attention {name} at "
              f"{tuple(t['shape'])} bf16: {json.dumps(t)}", flush=True)
    print(f"serving end to end {tag}: {json.dumps(serving)}", flush=True)

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
                     "device_ms": t["device_ms"], "shape": t["shape"]})
    t = flash_t["causal"]
    k = fa.FLASH_ATTENTION_KERNEL
    rows.append({"name": k.name, "route": "cuda",
                 "source": str(k.source.relative_to(ROOT)),
                 "replaces": REPLACES[k.name],
                 "launches": serve_launches[k.name],
                 "max_abs_err": max(*flash_err.values(), *main_err.values()),
                 "ms": t["ms"], "plain_ms": t["plain_ms"],
                 "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                 "library_ms": t["library_ms"], "device_ms": t["device_ms"],
                 "shape": t["shape"], "window1024": {
                     key: flash_t["window1024"][key] for key in (
                         "ms", "device_ms", "plain_ms", "library_ms",
                         "bound_ms", "bound_by")}})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
