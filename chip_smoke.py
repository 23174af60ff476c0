#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each (every time beside the card's name and power limit):

1. card   — ``nvidia-smi`` name and power limit; fails without CUDA;
2. build  — both affinity kernels from ``src/repro_torch/kernels/affinity/
   csrc/*.cu`` with ``nvcc``, in parallel;
3. kernels vs plain — each CUDA kernel against its plain PyTorch version on
   the card, bit for bit, at tile-edge shapes and at the main path's shapes,
   with rows that are all tied (the lowest index must win) and rows with no
   valid worker (``-1``);
4. main path — the port's ``Platform`` on the reference scheduler-scale rig
   (16384 workers of 64 MB, 50% pre-occupied, 5% sparse warm residency):
   512 ``decide()`` calls, ``decide_batch`` waves of 512 with
   ``apply=False``, one ``apply=True`` wave.  The decisions must equal the
   same run on the float64 ``backend="np"`` twin, and both kernels' launch
   counters must have moved.  Then each kernel against its plain version
   on the card, bit for bit, on the inputs the main path gives it (every
   function's per-arrival rows, a wave's rows) from the live session;
5. times — each kernel's CUDA-event time at the main path's shapes and at
   the 512-tag, 512-row scale, its profiler device time, its plain
   version's times, and its bound; end-to-end us/decision per arrival and
   per wave of 512, beside the float64 host twin's on the same host, and
   the per-arrival valid call with two of its parts (inputs to the card,
   the result back to the host);

then a ``{"kernels": [...]}`` line, the card line, and the result line
``{"ok": true, "device": {...}}``.  Any failed phase raises: the script
exits non-zero and prints no result line.
"""
from __future__ import annotations

import collections
import json
import random
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.ast import (AAppScript, Affinity, Block,  # noqa: E402
                                  Invalidate, TagPolicy)
from repro_torch.core.state import ClusterState, Registry  # noqa: E402
from repro_torch.kernels.affinity import (KERNELS, NO_CAP,  # noqa: E402
                                          NO_CONC, affinity_valid,
                                          affinity_valid_np, bulk_decide)
from repro_torch.kernels.affinity.bulk_ref import bulk_decide_ref  # noqa: E402
from repro_torch.kernels.affinity.ops import as_inputs  # noqa: E402
from repro_torch.kernels.affinity.ref import affinity_valid_ref  # noqa: E402
from repro_torch.kernels.build import build_all  # noqa: E402
from repro_torch.platform import Platform  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, at the full 700 W limit)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

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
            "bulk_decide": "src/repro/kernels/affinity/bulk_kernel.py:31"}


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

    # 2. build, from the sources in this checkout
    for k in KERNELS:
        k.library_path().unlink(missing_ok=True)
    build_s = build_all(KERNELS)
    print(f"build: {', '.join(k.name for k in KERNELS)} built in "
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

    # 4. the main path at full size, held to the float64 twin
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
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
