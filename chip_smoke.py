#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--baseline-scan PATH] [--baseline-affinity DIR]
                          [--baseline-flash PATH]

Phases, one line each (every time beside the card's name and power limit):

1. card   — ``nvidia-smi`` name and power limit; fails without CUDA;
2. build  — the five kernels from ``src/repro_torch/kernels/*/csrc/*.cu``
   with ``nvcc``, one process per source, in parallel; the bf16 flash
   kernel's compiled tiles (``flash_attention_bf16_tiles``) must be
   ``kernel.TILES`` for every head dim;
3. kernels vs plain — each affinity kernel against its plain PyTorch version
   on the card, bit for bit, at the edges of its geometry
   (``AFFINITY_CASES``) and at the main path's shapes, with rows that are
   all tied (the lowest index must win) and rows with no valid worker
   (``-1``); the float32 flash-attention kernel against
   its plain version within 2e-5 and the bf16 one against the plain
   version on its inputs widened to float32, element by element within the
   bound of its two roundings, on the whole inputs and on v restricted to a
   late key tile, each with a dropped key tile shown to exceed 4x that
   bound, at ragged lengths, Sq != Skv, GQA ratios 1, 2, 4 and the moe and
   hybrid families' 7 and 8, head dims 64, 128, 256, window 1 and a window
   past the sequence, causal with a window at Sq != Skv, and the enc-dec
   family's ratio 1 at hd 64 (non-causal at Sq < Skv and Sq > Skv with a
   ragged last key tile, and causal); the selective-scan
   kernel against its plain version within 1e-4 at the shapes of
   ``tests/test_kernels.py``'s sweep and around its tiling (S below and
   across 64-step chunks, D off its 32-channel tile and off a multiple of
   8, every N, float32 and bfloat16 inputs, and jamba's D = 16384), and on
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
   layer, captured from the live prefill (the captured kinds must be the
   model's; its bound and dropped-tile control as in phase 3), and the
   float32 kernel on them widened;
7. whole model in float32 — one local:global period of gemma3-4b at full
   width (6 layers), S = 2048: prefill logits through the float32 flash
   kernel (6 launches, none of the bf16 one) against the direct path;
8. serving times — both flash kernels at (1, 4096, 8, 4, 256) in their
   types, causal and window 1024 (CUDA-event and profiler ms, plain ms,
   ``scaled_dot_product_attention`` ms, bound, and for bf16 the MUFU floor
   of its exp2s); with ``--baseline-flash PATH`` an earlier
   ``flash_attention_sm90.cu`` built and timed beside the bf16 kernel, in
   turns, on the same inputs, here and at phases 15's and 16's bf16
   shapes; prefill ms and tokens/s,
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
   against its plain version on the card, within 1e-4 max(1, max |logit|)
   (``model_f32``, which phase 15 runs on jamba);
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
   and the float64 twin's (both twins in processes of their own, beside
   the card's runs);
13. predictive trace — the forecast plug-in on the same cluster:
   ``benchmarks/coldstart.py``'s predictive column (its script, the
   ``predictive`` keep-alive over a 512 MB-a-worker pool, an
   ``ArrivalForecast`` seeded from the script's affinity terms and fed by
   the driver, a ``ForecastPlanner`` epoching every simulated second with
   migration cost 0.25 s) on the ``chained`` scenario at 2 roots/s a
   replica, over a 1.25 s window of roots, stopped after the second
   planning epoch, decided one arrival at a time through
   ``affinity_valid``: its records, rng tail, pool metrics and planner
   stats must equal the ``device="cpu"`` run's and the float64 twin's
   (each in a process of its own, beside the card's run), some
   epoch must prewarm, every prewarm and migration target must pass the
   port's scalar Listing-1 ``valid`` on the state it was planned on, and
   ``affinity_valid`` must launch once a decision; the same trace under the
   ``affinity`` policy (on the CPU, beside it) for its cold-start rate;
   the planner's host ms per epoch;
14. MoE serving path — falcon-mamba-7b's weights freed, qwen3-moe-30b-a3b
   whole (48 layers, 128 experts, top-8, bf16, 60.2 GB, drawn on the card)
   behind the same engine, deployment, sessions, decodes and cell failure
   as phase 6, with phase 6's checks (48 bf16 flash launches a prefill,
   none of the float32 kernel or the scan) and flash held to the plain
   version on the first layer's captured q / k / v at (1, 4096, 32, 4,
   64); its prefill, decode and scheduling numbers, where one prefill's and
   one decode step's time goes, and one ``moe_ffn`` layer alone at the
   prefill's and the decode's shapes beside its bound;
15. hybrid and MoE at full width — jamba-1.5-large-398b with 2 layers
   (attention + dense FFN, mamba + MoE; 23.8 GB) and arctic-480b with 1
   (attention, MoE with its dense residual; 28.1 GB), each in bf16 through
   ``model_forward`` / ``model_decode_step``: one prefill of 4096 tokens
   (bf16 flash launched once an attention layer, the scan once a mamba
   layer, nothing else) and 8 decode steps from an empty cache, as the
   serving runner decodes (context 1 to 8), with finite logits; bf16 flash
   on the captured inputs at (1, 4096, 64, 8, 128) and (1, 4096, 56, 8,
   128) with its controls, the scan on the captured inputs at D = 16384
   within 1e-4 max(1, max |y|); jamba's 2 layers in float32 at S = 2048:
   the logits at every position through the float32 flash and scan kernels
   against their plain versions on the card within 1e-4 max(1, max
   |logit|); then bf16 flash at the three models' shapes and the scan at D
   = 16384 timed as in phases 8 and 11;
16. enc-dec and vlm serving — seamless-m4t-large-v2 whole (24 encoder and
   24 decoder layers, 16:16 heads of 64, bf16, 1.635 B parameters) behind
   the same engine, deployment, sessions, decodes and cell failure as
   phase 6: a prefill encodes 2048 seeded frames (the stub audio
   frontend) once, runs the decoder over 2048 target tokens on that
   encoding and builds the decode cache's cross K / V from it
   (``EncDecRunner``); phase 6's checks with 72 bf16 flash launches a
   prefill (24 encoder, 24 decoder self, 24 cross), and flash held to the
   plain version on the first call of each of the three; bf16 flash timed
   at (1, 2048, 16, 16, 64) non-causal and causal; two layers a side in
   float32 at S = 2048 through ``model_f32``.  Then internvl2-76b at full
   width with 4 of its 80 layers (11.2 GB) behind the same engine: 256
   seeded patch features and 3840 tokens a prefill, 4 bf16 flash launches
   a prefill at (1, 4096, 64, 8, 128);
17. training — under ``torch.use_deterministic_algorithms(True)``, no
   kernel launched: gemma3-4b whole in bf16, 4 ``make_train_step`` steps
   at B = 1, S = 1024 with AdamW's defaults on ``make_batch``'s batches
   (finite losses and grad norms, every parameter moved), the step split
   into forward, backward and optimizer, its idle share and its bound;
   before the steps one step counted on ``meta`` with the same arguments
   live, and each step's measured peak (``max_memory_allocated`` after a
   reset right before it) within 5% of the counted peak; a
   6-layer full-width crash-restart through ``CheckpointManager``, losses
   and parameters bit-identical to the straight run; reduced gemma3-4b in
   float32, one step and its gradients on the card against the CPU;
18. mesh and roofline tooling — (a) ``python -m repro_torch.launch.dryrun
   --device cuda`` at full size, one subprocess each, started after phase 5
   and run beside phases 6-16 on the host's CPU: gemma3-4b train_4k and
   falcon-mamba-7b prefill_32k on the (32, 8) mesh of 256 fake ranks,
   gemma3-4b train_4k on (2, 32, 8); each record ``status: ok``, positive
   flops, per-device arguments under 80 GB, the reference's memory keys
   with a peak that holds the arguments, its compute, memory and
   collective terms and its peak, temp and output GB a device printed;
   (b) ``RooflineOracle.add_module`` at the H100's peaks over one prefill
   of 4096 tokens (B = 1, bf16) of gemma3-4b and of falcon-mamba-7b (its
   chunked scan), each timed after and held at or above the bound; phase 17's train step as counted on ``meta`` priced
   beside its hand-worked bound; (c) a one-rank NCCL process group, a (1, 1)
   ``DeviceMesh``: gemma3-4b with 6 layers at full width, a prefill with
   DTensor parameters under the activation rules bit-identical to the
   plain one;
19. ssm and hybrid training — under deterministic algorithms, no kernel
   launched (the scan kernel's counter stays 0): falcon-mamba-7b at full
   width with 40 of 64 layers (``SSM_TRAIN_LAYERS``), bf16, B = 1, S =
   1024, ``remat="full"``, 4 steps through the differentiable scan, as
   phase 17, its peak counted and checked as phase 17's; reduced
   falcon-mamba-7b and jamba in float32, card vs CPU; jamba's full width
   printed as not fitting one card;

then the seconds each phase took, a ``{"kernels": [...]}`` line, the card
line, and the result line
``{"ok": true, "device": {...}}``.  Any failed phase raises: the script
exits non-zero and prints no result line.
"""
from __future__ import annotations

import atexit
import collections
import copy
import ctypes
import dataclasses
import functools
import gc
import json
import math
import os
import random
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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
from repro_torch.analysis import RooflineOracle  # noqa: E402
from repro_torch.configs import param_counts  # noqa: E402
from repro_torch.configs.registry import (  # noqa: E402
    ARCTIC_480B, FALCON_MAMBA_7B, GEMMA3_4B, INTERNVL2_76B, JAMBA_15_LARGE,
    QWEN3_MOE_30B, SEAMLESS_M4T_LARGE_V2)
from repro_torch.core.ast import (AAppScript, Affinity, Block,  # noqa: E402
                                  Invalidate, TagPolicy)
from repro_torch.core.scheduler import candidate_blocks, valid  # noqa: E402
from repro_torch.core.state import ClusterState, Registry  # noqa: E402
from repro_torch.forecast import (ArrivalForecast,  # noqa: E402
                                  ForecastPlanner, PlanConfig, Prewarm)
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
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16  # noqa: E402
from repro_torch.launch.train import (load_train_state,  # noqa: E402
                                      train_state)
from repro_torch.models import (init_cache, init_model,  # noqa: E402
                                model_decode_step, model_forward,
                                model_loss, params_shape)
from repro_torch.models import encdec as ed  # noqa: E402
from repro_torch.models.moe import moe_ffn  # noqa: E402
from repro_torch.models.transformer import lm_logits  # noqa: E402
from repro_torch.obs import Obs, validate_chrome_trace  # noqa: E402
from repro_torch.platform import Platform  # noqa: E402
from repro_torch.pool import StartCosts, WarmPool, make_policy  # noqa: E402
from repro_torch.roofline.flops import OpCounter  # noqa: E402
from repro_torch.sharding import specs as sh  # noqa: E402
from repro_torch.sharding.ctx import sharding_rules  # noqa: E402
from repro_torch.resilience import (HEAL_ZONE, KILL_ZONE,  # noqa: E402
                                    ChaosHarness, Fault, Resilience,
                                    RetryPolicy)
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.data.pipeline import make_batch  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.step import (batch_to, make_prefill_step,  # noqa: E402
                                    make_train_step)
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
# the SFU's exp2: 16 a clock on each of the 132 SMs, at the 1.98 GHz boost
MUFU_EXP2_PER_S = 16 * 132 * 1.98e9

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
# or under a window the one most rows see (dropped_tile); with neither a
# causal mask nor a window, where every row sees every key, the first
# FLASH_DROP_SHARE of the key tiles go instead (dropped_span), so that the
# control's margin does not shrink with the keys' count.  A row that sees
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
FLASH_DROP_SHARE = 0.25
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


def device_split(fn, iters: int = 50, attempts: int = 6):
    """Device time per call by kernel (and copy) name, from
    ``torch.profiler``: ``{name: {"ms": ms per call, "per_call": events per
    call}}``; empty when the profiler sees no device activity.  A trace
    that lost events (none at all, or a count that is not a whole number of
    calls) is taken again, up to ``attempts`` times; the last one is
    returned as it is."""
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
        if split and all(v["per_call"] == int(v["per_call"])
                         for v in split.values()):
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
#: 257), Sq != Skv non-causal, GQA ratios H / K of 1, 2, 4, 7 and 8, head
#: dims 64, 128 and 256, window 1 and a window past the sequence, causal
#: with a window at Sq > Skv and Sq < Skv (the kernel's key-tile bounds),
#: and the enc-dec family's ratio 1 at hd 64: non-causal with a ragged last
#: key tile (the encoder, and cross-attention at Sq < Skv and Sq > Skv) and
#: causal (the decoder's self-attention).  For each head dim's tiles
#: (``kernel.TILES``) they hold an Sq off its query rows, an Skv off its
#: key tile, a window under its key tile and a causal diagonal across a
#: consumer's rows (tests/test_torch_flash_attention.py checks it): at
#: hd 64, Sq = 129 leaves the last CTA one row (its second consumer none)
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
    # the moe and hybrid families' GQA ratios: 8 at hd 64 (qwen3-moe-30b-a3b,
    # 32:4), 8 at hd 128 (jamba-1.5-large-398b, 64:8), 7 (arctic-480b, 56:8)
    (1, 257, 257, 32, 4, 64, True, None),
    (1, 300, 300, 64, 8, 128, True, None),
    (1, 257, 257, 56, 8, 128, True, None),
    # seamless-m4t-large-v2: 16:16 heads of 64
    (1, 257, 300, 16, 16, 64, False, None),
    (1, 257, 257, 16, 16, 64, True, None),
    (1, 385, 200, 16, 16, 64, False, None),
    # the tiles of hd 64 and 128 (128 rows, 128 keys): a ragged last CTA
    # and key tile, a window under the key tile
    (1, 193, 193, 32, 4, 64, True, None),
    (1, 129, 385, 16, 16, 64, False, None),
    (1, 450, 450, 8, 8, 128, True, 100),
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
                   every: bool = True, span: int = 1) -> torch.Tensor:
    """[Sq] bool: the query rows that see every key of the ``span`` 64-key
    tiles from ``tile`` (``every``), or some key of them."""
    qi = torch.arange(Sq)
    a, b = tile * FLASH_TILE, min((tile + span) * FLASH_TILE, Skv) - 1
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


def dropped_span(Skv: int, causal: bool, window) -> int:
    """How many 64-key tiles, from :func:`dropped_tile`, the control on the
    whole inputs drops: one, or with neither a causal mask nor a window the
    first FLASH_DROP_SHARE of them."""
    if causal or window is not None:
        return 1
    return max(1, math.ceil(FLASH_DROP_SHARE * -(-Skv // FLASH_TILE)))


def late_tile(Sq: int, Skv: int, causal: bool) -> int:
    """A 64-key tile that only late query rows see: under a causal mask the
    one before the last row's diagonal tile (or the first, when that is the
    diagonal's), else the last."""
    last = (min(Sq, Skv) if causal else Skv) - 1
    return max(last // FLASH_TILE - 1, 0) if causal else last // FLASH_TILE


def tile_rows(v: torch.Tensor, tile: int, keep: bool,
              span: int = 1) -> torch.Tensor:
    """``v`` with the key rows of the ``span`` 64-key tiles from ``tile``
    zeroed, or with every other key row zeroed (``keep``)."""
    a, b = tile * FLASH_TILE, (tile + span) * FLASH_TILE
    if keep:
        out = torch.zeros_like(v)
        out[:, a:b] = v[:, a:b]
        return out
    out = v.clone()
    out[:, a:b] = 0
    return out


def flash_bf16_check(got, q, k, v, causal, window, tile: int,
                     span: int = 1):
    """A bf16 output ``got`` for q, k, v (the kernel's) against the plain
    version on them widened to float32 (:func:`flash_bf16_bound`), and the
    control: the plain version with the v rows of the ``span`` 64-key tiles
    from ``tile`` zeroed.  Raises unless every element is within its
    tolerance and the control moves some element of a row that sees all of
    them (else of one that sees some) by at least FLASH_DROP x its
    tolerance (an element whose tolerance is 0, a row that sees no key of a
    v that is zero there, must match exactly).  Returns the key tiles, the
    largest difference, the largest difference over its element's
    tolerance, the control's largest difference over tolerance, and the
    medians of the tolerance and of |output| over the elements whose
    tolerance is not 0."""
    want, tol = flash_bf16_bound(q, k, v, causal, window)
    if got.dtype != q.dtype or got.shape != want.shape:
        raise AssertionError("flash_attention returned another dtype or "
                             "shape than its inputs")

    def over(d, rows=slice(None)):  # the largest d / tol, 0 / 0 as 0
        return float((d / tol)[:, rows].nan_to_num(nan=0.0).max())

    diff = (got.float() - want).abs()
    err = over(diff)
    where = f"at q {tuple(q.shape)}, k {tuple(k.shape)}, causal={causal}, " \
            f"window={window}, key tiles {tile}-{tile + span - 1}"
    if not bool((diff <= tol).all()):
        raise AssertionError(
            f"bf16 flash_attention differs from its plain version by "
            f"{err} x the tolerance of an element "
            f"(max abs err {float(diff.max())}) {where}")
    dropped = fa.flash_attention_ref(q.float(), k.float(),
                                     tile_rows(v.float(), tile, keep=False,
                                               span=span),
                                     causal=causal, window=window)
    Sq, Skv = q.shape[1], k.shape[1]
    rows = tile_rows_seen(Sq, Skv, causal, window, tile, span=span)
    if not rows.any():
        rows = tile_rows_seen(Sq, Skv, causal, window, tile, every=False,
                              span=span)
    drop = over((dropped - want).abs(), rows.to(want.device))
    if not drop >= FLASH_DROP:
        raise AssertionError(
            f"dropping key tiles moves the plain version by at most {drop} "
            f"x the bf16 tolerance, under {FLASH_DROP}, {where}")
    return {"tile": tile, "span": span, "max_abs_err": float(diff.max()),
            "err_over_tol": err, "drop_over_tol": drop,
            "median_tol": float(tol[tol > 0].median()),
            "median_abs_output": float(want.abs()[tol > 0].median())}


def compare_flash(q, k, v, causal, window):
    """The flash kernel against its plain version on the same card inputs;
    raises past the tolerance.  float32: returns the largest difference.
    bf16: :func:`flash_bf16_check` on the whole inputs (the control drops
    :func:`dropped_tile`'s :func:`dropped_span` tiles) and on v restricted
    to :func:`late_tile`; returns
    the largest difference of the two and both checks' numbers."""
    if q.dtype == torch.bfloat16:
        Sq, Skv = q.shape[1], k.shape[1]
        kw = dict(causal=causal, window=window)
        whole = flash_bf16_check(fa.flash_attention(q, k, v, **kw), q, k, v,
                                 tile=dropped_tile(Sq, Skv, causal, window),
                                 span=dropped_span(Skv, causal, window), **kw)
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
    every model of the serving runs)."""
    g = torch.Generator(device="cuda").manual_seed(100 + int(session[1:]))
    return torch.randint(0, vocab, (1, PROMPT), generator=g, device="cuda")


def session_batch(cfg, session: str) -> dict:
    """A session's prefill batch for ``cfg``, PROMPT positions in all: the
    prompt's tokens; for the vlm family, n_patches seeded patch features
    [1, n_patches, frontend_dim] (float32, the stub vision frontend)
    followed by PROMPT - n_patches tokens; for the enc-dec family, seeded
    frames [1, PROMPT // 2, frontend_dim] (float32, the stub audio
    frontend) and PROMPT // 2 target tokens, as ``data.pipeline.make_batch``
    splits a sequence (S_src = S_tgt)."""
    tokens = session_prompt(session, cfg.vocab)
    g = torch.Generator(device="cuda").manual_seed(200 + int(session[1:]))
    if cfg.family == "encdec":
        half = PROMPT // 2
        return {"frames": torch.randn((1, half, cfg.frontend_dim),
                                      generator=g, device="cuda"),
                "tokens": tokens[:, :half]}
    if cfg.frontend == "vision":
        return {"patches": torch.randn((1, cfg.n_patches, cfg.frontend_dim),
                                       generator=g, device="cuda"),
                "tokens": tokens[:, :PROMPT - cfg.n_patches]}
    return {"tokens": tokens}


class ServeRunner:
    """The runner ``launch/serve.py`` gives the engine, on the full model: a
    prefill runs the prefill step (attention through the flash kernel, mamba
    layers through the scan kernel) on the session's batch
    (:func:`session_batch`) and makes an empty cache (the JAX package has no
    prefill-into-cache for LMs); a decode runs ``model_decode_step`` on the
    session's last token.  It keeps each request's host seconds and whether
    every logit was finite."""

    def __init__(self, cfg, model):
        self.cfg, self.model = cfg, model
        self.prefill = make_prefill_step(cfg, impl="flash")
        self.caches, self.last = {}, {}
        self.prefill_s, self.decode_s = [], []
        self.finite = True

    def start(self, batch):
        """One prefill: (last-position logits [1, vocab], the decode
        cache)."""
        return self.prefill(self.model, batch), None

    def __call__(self, req: Request, cell: str):
        if req.kind == "prefill":
            batch = session_batch(self.cfg, req.session)
            t0 = time.perf_counter()
            logits, cache = self.start(batch)
            self.finite &= bool(torch.isfinite(logits).all())
            self.prefill_s.append(time.perf_counter() - t0)
            self.caches[(req.session, cell)] = cache if cache is not None \
                else init_cache(self.cfg, 1, MAX_LEN, device="cuda")
            self.last[req.session] = int(batch["tokens"][0, -1])
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


class EncDecRunner(ServeRunner):
    """:class:`ServeRunner` for the enc-dec family: a prefill encodes the
    session's frames once, runs the decoder pass over its target tokens on
    that encoding (``models.encdec.decode_hidden``) for the last position's
    logits, and builds the decode cache from the same encoding
    (``encdec_prefill_cache``: every layer's cross K / V, an empty self
    cache of MAX_LEN slots)."""

    @torch.no_grad()
    def start(self, batch):
        cfg, model = self.cfg, self.model
        enc_out = ed.encode(cfg, model, batch["frames"], impl="flash")
        hidden = ed.decode_hidden(cfg, model, batch["tokens"], enc_out,
                                  impl="flash")
        logits = lm_logits(cfg, model, hidden[:, -1:])[:, 0]
        return logits, ed.encdec_prefill_cache(cfg, model, enc_out, 1,
                                               MAX_LEN)


def flash_calls(cfg) -> int:
    """Attention calls a prefill makes: one per attention layer, and for
    the enc-dec family one per encoder layer and two per decoder layer
    (self and cross)."""
    if cfg.family == "encdec":
        return cfg.enc_layers + 2 * cfg.n_layers
    return attention_layers(cfg)


def flash_kind(cfg, call: int, causal: bool, window) -> str:
    """What the ``call``-th attention call of a serving run is: ``local``
    (windowed) or ``global``; for the enc-dec family, by its place in a
    prefill, ``encoder``, ``decoder_self`` or ``cross``."""
    if cfg.family == "encdec":
        i = call % flash_calls(cfg)
        if i < cfg.enc_layers:
            return "encoder"
        return ("decoder_self", "cross")[(i - cfg.enc_layers) % 2]
    return "global" if window is None else "local"


class FlashCapture:
    """Stands in for the package's ``flash_attention`` during a run of
    ``cfg`` and keeps the q / k / v of the first call of each kind
    (:func:`flash_kind`); every call goes on to the kernel."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.kernel = fa.flash_attention
        self.seen = {}
        self.calls = 0

    def __call__(self, q, k, v, *args, **kw):
        causal, window = kw.get("causal", True), kw.get("window")
        kind = flash_kind(self.cfg, self.calls, causal, window)
        self.calls += 1
        self.seen.setdefault(kind, (q, k, v, causal, window))
        return self.kernel(q, k, v, *args, **kw)


def drive_serving(cfg, model):
    """The serving path once: ``launch/serve.py``'s engine and deployment,
    SESSIONS prefills, DECODES decodes drawn from a seeded generator, and
    session s0's cell failed before decode FAIL_AT.  Returns the engine,
    the runner, the host us of scheduling per submitted request (the
    submit's wall time less the runner's), the failed cell, the sessions
    it moved, and whether every decode ran on its session's cell."""
    runner = (EncDecRunner if cfg.family == "encdec" else ServeRunner)(
        cfg, model)
    with warnings.catch_warnings():  # the v1 call shape, as launch/serve.py
        warnings.simplefilter("ignore", DeprecationWarning)
        eng = Engine(two_pod_cells(), runner=runner, heartbeat_timeout=1e9,
                     device="cuda")
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
    cfg, model, _ = full_width(base, base.period, "float32", seed=1)
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


def flash_entry(kernel, q, k, v, causal: bool, window):
    """The bare ctypes entry point of ``kernel`` (a CudaKernel with
    ``flash_attention_bf16_launch``'s signature) on these card inputs, with
    o allocated and every argument converted to its ctypes type once: a
    call with none of the wrapper's Python.  Returns the call, which holds
    the tensors it reads and writes, and o."""
    o = torch.empty_like(q)
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    fn = kernel.fn()
    args = (*(ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, o)),
            *(ctypes.c_int64(x) for x in (
                B, Sq, Skv, H, K, hd, int(bool(causal)),
                0 if window is None else int(window))),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))

    def call(buffers=(q, k, v, o)):  # alive as long as the call
        return fn(*args)

    rc = call()
    if rc != 0:
        raise AssertionError(f"{kernel.name}: the bare launch failed: CUDA "
                             f"error {rc}")
    return call, o


def flash_baseline(baseline, q, k, v, causal: bool, window) -> dict:
    """An earlier ``flash_attention_sm90.cu`` (``baseline``, a CudaKernel)
    against the current bf16 kernel on the same card inputs, both through
    their bare entries (:func:`flash_entry`): CUDA-event and profiler
    device ms in turns (baseline, new, new, baseline), and each one's
    output held to the plain version as :func:`flash_bf16_check` holds the
    kernel's (raises past the tolerance)."""
    old, o_old = flash_entry(baseline, q, k, v, causal, window)
    new, o_new = flash_entry(fa.FLASH_ATTENTION_BF16_KERNEL, q, k, v, causal,
                             window)
    torch.cuda.synchronize()
    Sq, Skv = q.shape[1], k.shape[1]
    tile = dropped_tile(Sq, Skv, causal, window)
    span = dropped_span(Skv, causal, window)
    err = {name: flash_bf16_check(o, q, k, v, causal, window, tile,
                                  span)["err_over_tol"]
           for name, o in (("baseline", o_old), ("new", o_new))}
    timed = collections.defaultdict(list)
    for name, fn in (("baseline", old), ("new", new), ("new", new),
                     ("baseline", old)):
        timed[f"{name}_ms"].append(cuda_ms(fn, iters=50, warmup=5))
        timed[f"{name}_device_ms"].append(device_ms(fn, iters=20))
    return {"source": str(baseline.source), "err_over_tol": err,
            "max_abs_diff": max_abs_err(o_old.float(), o_new.float()),
            **timed}


def time_flash(dtype, window, seed: int, shape=(1, PROMPT, 8, 4, 256),
               causal: bool = True, baseline=None):
    """The flash kernel for ``dtype`` at ``shape`` (B, S, H, K, hd;
    gemma3-4b's serving shape unless given), causal with ``window`` (or
    not causal, with no window): CUDA-event ms per call, profiler device
    ms, the plain version's ms, ``scaled_dot_product_attention``'s
    CUDA-event and device ms on the same inputs (``is_causal`` with
    ``enable_gqa``; the window as an explicit mask) and the bound: the
    larger of every input read once and the output written once over HBM,
    and the mask's useful multiply-adds (q k^T and p v, 4 hd flops per
    admitted pair and head) at the peak rate for the type (dense bf16 on the
    tensor cores; float32 on the CUDA cores, since a TF32 product would not
    hold the float32 tolerance).  Beside the bound, the MUFU floor of the
    bf16 kernel's exp2s: one per admitted pair and head, 16 a clock on each
    of the 132 SMs at 1.98 GHz (None for float32).  With ``baseline`` (a
    CudaKernel of an earlier ``flash_attention_sm90.cu``; bf16 only),
    :func:`flash_baseline` on the same inputs."""
    import torch.nn.functional as F

    B, S, H, K, hd = shape
    q, k, v = flash_inputs(B, S, S, H, K, hd, dtype, seed)
    kern = lambda: fa.flash_attention(q, k, v, causal=causal,  # noqa: E731
                                      window=window)
    plain = lambda: fa.flash_attention_ref(  # noqa: E731
        q, k, v, causal=causal, window=window)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window is None:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=causal, enable_gqa=True)
    else:
        i = torch.arange(S, device="cuda")
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
    nbytes = q.element_size() * (q.numel() + k.numel() + v.numel() +
                                 q.numel())
    pairs = B * H * (masked_pairs(S, window) if causal else S * S)
    flops = 4 * hd * pairs
    bf16 = dtype == torch.bfloat16
    peak = BF16_FLOPS_PER_S if bf16 else FP32_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    out = {"shape": [B, S, H, K, hd], "dtype": str(dtype)[6:],
           "causal": causal, "window": window,
           "ms": cuda_ms(kern, iters=50, warmup=5),
           "device_ms": device_ms(kern, iters=20),
           "plain_ms": cuda_ms(plain, iters=10, warmup=2),
           "library_ms": cuda_ms(lib, iters=50, warmup=5),
           "library_device_ms": device_ms(lib, iters=20),
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "mufu_floor_ms": pairs / MUFU_EXP2_PER_S * 1e3 if bf16 else None,
           "useful_gflop": flops / 1e9, "mbytes": nbytes / 1e6}
    if baseline is not None:
        out["baseline"] = flash_baseline(baseline, q, k, v, causal, window)
    return out


def full_width(base, n_layers: int, dtype: str = "bfloat16", seed: int = 0):
    """``base`` at its published widths with ``n_layers`` layers (an
    enc-dec model: that many on each side) in ``dtype``, drawn on the card
    from a generator seeded with ``seed``; returns the config, the model
    and the seconds the draw took."""
    cfg = dataclasses.replace(base, n_layers=n_layers, dtype=dtype,
                              enc_layers=n_layers if base.enc_layers else 0)
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                       device="cuda")
    torch.cuda.synchronize()
    return cfg, model, time.perf_counter() - t0


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
    cfg, model, init_s = full_width(cfg, cfg.n_layers, cfg.dtype)
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
    depth = f"{cfg.enc_layers} encoder + " if cfg.enc_layers else ""
    print(f"serving path: {cfg.name} ({depth}{cfg.n_layers} layers, "
          f"{n_params / 1e9:.3f} B parameters, bf16, drawn on the card in "
          f"{init_s:.2f} s) behind serve.Engine on {len(two_pod_cells())} "
          f"cells; {SESSIONS} prefills of {PROMPT} tokens, {DECODES} decodes"
          f", cell {victim} failed before decode {FAIL_AT} (re-prefilled "
          f"{moved}); {len(eng.completions)} completions ok, decodes on "
          f"their session's cell, logits finite; launches {launches} "
          f"({n_prefills} prefills)", flush=True)
    return model, eng, runner, sched_us, launches


def attention_layers(cfg) -> int:
    """The layers of ``cfg`` whose mixer is attention (the rest are
    mamba)."""
    return sum(cfg.layer_kind(i % cfg.period) != "mamba"
               for i in range(cfg.n_layers))


def serving_path(cfg):
    """Phases 6, 14 and 16: ``cfg`` behind ``serve.Engine``
    (:func:`serve_whole`), the bf16 flash counter checked at one launch per
    attention call of a prefill (:func:`flash_calls`) and the float32 flash
    and scan counters at none, and both flash kernels held to the plain
    version on the q / k / v of the first call of each attention kind
    (global, and local where the model has windowed layers; encoder,
    decoder self and cross for the enc-dec family) the run captured (bf16
    as captured, and the float32 kernel on them widened).  With MoE FFNs,
    one MoE layer alone at the prefill's and the decode's shapes
    (:func:`time_moe`).  Returns the launches, those comparisons' errors
    and the run's end-to-end numbers."""
    capture = FlashCapture(cfg)
    model, eng, runner, sched_us, serve_launches = serve_whole(
        cfg, fa, "flash_attention", capture)
    n_prefills = len(runner.prefill_s)
    n_attn = flash_calls(cfg)
    if serve_launches["flash_attention_bf16"] != n_attn * n_prefills \
            or serve_launches["flash_attention"] != 0 \
            or serve_launches["selective_scan"] != 0:
        raise AssertionError(f"serving path launches {serve_launches} for "
                             f"{n_prefills} prefills of {n_attn} attention "
                             "calls")
    kinds = {"local" if cfg.layer_kind(i % cfg.period) == "local"
             else "global" for i in range(cfg.n_layers)
             if cfg.layer_kind(i % cfg.period) != "mamba"}
    if cfg.family == "encdec":
        kinds = {"encoder", "decoder_self", "cross"}
        if {k: c for k, (*_, c, _) in capture.seen.items()} != {
                "encoder": False, "decoder_self": True, "cross": False}:
            raise AssertionError("enc-dec serving: the captured calls' "
                                 "causal flags are not the encoder's, the "
                                 "decoder's and the cross-attention's")
    if set(capture.seen) != kinds:
        raise AssertionError(f"serving path captured the attention kinds "
                             f"{sorted(capture.seen)}, where {cfg.name}'s "
                             f"layers have {sorted(kinds)}")
    main, main_err, main_f32 = {}, {}, {}
    for kind in sorted(capture.seen):
        q, k, v, causal, window = capture.seen[kind]
        main_err[kind], main[kind] = compare_flash(q, k, v, causal, window)
        q, k, v = (t.float() for t in (q, k, v))
        main_f32[kind] = compare_flash(q, k, v, causal, window)[0]
    shapes = {kind: tuple(seen[0].shape)
              for kind, seen in sorted(capture.seen.items())}
    print(f"flash_attention vs plain at the serving path's inputs (the first"
          f" layer of each attention kind in the first prefill, q {shapes}, "
          f"{cfg.n_kv_heads} kv heads): the bf16 kernel per element within "
          f"tolerance, on the whole inputs and on v restricted to a late key"
          f" tile, each with its dropped-tile control (at least "
          f"{FLASH_DROP} x tolerance) {json.dumps(main)}; the float32 kernel"
          f" on the same inputs widened, max abs err {main_f32} (tolerance "
          f"{FLASH_TOL[torch.float32]})", flush=True)
    capture.seen.clear()
    serving = serving_numbers(cfg, model, runner, sched_us,
                              "flash_fwd_bf16_sm90", "flash")
    serving["flash_vs_plain_main_path"] = {
        "bf16": main, "float32_err": main_f32}
    moe = next((layer.moe for layer in getattr(model, "layers", ())
                if hasattr(layer, "moe")), None)
    if moe is not None:
        serving["moe_ffn_layer"] = time_moe(cfg, moe, seed=15)
    return serve_launches, main_err, main_f32, serving


def time_moe(cfg, moe, seed: int) -> dict:
    """One MoE layer alone (``models.moe.moe_ffn``) at the prefill's shape
    [1, PROMPT, d_model] and the decode's [1, 1, d_model] in the model's
    dtype, on seeded inputs: CUDA-event and profiler ms, where the device
    time goes (matrix products against the rest, the top kernels), and the
    bound: the larger of the weights, x and the output moved once over HBM,
    and the routed tokens' useful products (2 flops a multiply-add, a
    product per expert matrix and routing choice) at the bf16 rate.  The
    GShard dispatch reads every expert's weights whatever the routing, and
    computes every capacity slot, so the bound counts only what top-k
    needs; ``routed_bound_ms`` counts only the weights of the experts the
    routing of these inputs picks (at decode, top_k of them)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    spec, D = cfg.moe, cfg.d_model
    wbytes = sum(p.numel() * p.element_size() for p in moe.parameters())
    rbytes = moe.router.numel() * moe.router.element_size()
    mats = 3 if cfg.mlp_type == "swiglu" else 2
    out = {}
    for name, S in (("prefill", PROMPT), ("decode", 1)):
        x = torch.randn((1, S, D), generator=g, device="cuda").to(
            moe.w_up.dtype)
        fn = lambda: moe_ffn(moe, x, spec, cfg.mlp_type)  # noqa: E731
        io = 2 * x.numel() * x.element_size()
        flops = 2 * mats * S * spec.top_k * D * spec.d_ff_expert
        t_bytes, t_ops = (wbytes + io) / HBM_BYTES_PER_S, \
            flops / BF16_FLOPS_PER_S
        picked = torch.topk(x.float().reshape(S, D) @ moe.router,
                            spec.top_k).indices.unique().numel()
        routed = rbytes + (wbytes - rbytes) * picked / spec.n_experts + io
        out[name] = {"shape": [1, S, D], "ms": cuda_ms(fn, iters=10,
                                                       warmup=3),
                     "device_ms": device_ms(fn, iters=5),
                     "bound_ms": max(t_bytes, t_ops) * 1e3,
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations",
                     "experts_picked": picked,
                     "routed_bound_ms": max(routed / HBM_BYTES_PER_S,
                                            t_ops) * 1e3,
                     "weight_gb": wbytes / 1e9, "useful_gflop": flops / 1e9,
                     "breakdown": device_breakdown(fn, "\0", "none")}
    return out


def serving_numbers(cfg, model, runner, sched_us, marker: str, label: str):
    """A serving run's end-to-end numbers (prefill ms and tokens/s, decode
    ms per token, scheduling us per request, peak memory) and where one
    prefill's and one decode step's time goes on the card
    (:func:`device_breakdown`, the port's kernel picked out by
    ``marker``)."""
    batch = session_batch(cfg, "s0")
    # the enc-dec decode cache holds the encoding: one prefill makes it
    state = {"cache": runner.start(batch)[1] if cfg.family == "encdec"
             else init_cache(cfg, 1, MAX_LEN, device="cuda")}
    tok = batch["tokens"][:, -1:]

    def decode():
        with torch.no_grad():
            _, state["cache"] = model_decode_step(cfg, model, state["cache"],
                                                  tok)

    breakdown = {"prefill": device_breakdown(
                     lambda: runner.start(batch), marker, label),
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
#: instance); float32 and bfloat16 inputs (dt, x, b, c; a is float32); and
#: D = 16384, the widest the serving path gives it
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
    # jamba-1.5-large-398b's d_inner (2 x 8192), over two chunks
    (1, 70, 16384, 16, "bfloat16"),
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


def scan_serving_inputs(seed: int, D: int = 2 * FALCON_MAMBA_7B.d_model):
    """Seeded inputs at the serving path's shape (1, 4096, D, 16), D
    falcon-mamba-7b's d_inner unless given, with its types (dt float32,
    x / b / c bf16, a float32)."""
    B, S, N = 1, PROMPT, FALCON_MAMBA_7B.ssm.d_state
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


def time_scan(seed: int, baseline=None, D: int = 2 * FALCON_MAMBA_7B.d_model):
    """The scan kernel at the serving path's shape and types
    (:func:`scan_serving_inputs` at ``D``): CUDA-event ms per call through
    the package's ``selective_scan``, profiler device ms, the plain version's
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
    dt, x, b, c, a = ins = scan_serving_inputs(seed, D)
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
           "mufu_floor_ms_at_1.98GHz": B * S * D * N / MUFU_EXP2_PER_S
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
# 15. the hybrid and MoE families at full width, reduced depth
# --------------------------------------------------------------------------- #

HYBRID_DECODES = 8
HYBRID_DEPTHS = {"jamba-1.5-large-398b": 2, "arctic-480b": 1}


def hybrid_path(base) -> dict:
    """Phase 15, one model: ``base`` at full width with
    HYBRID_DEPTHS[base.name] layers in bf16, through ``model_forward`` /
    ``model_decode_step``: one prefill of PROMPT tokens with the flash and
    scan entries captured and every launch counter set to 0 just before it
    and read just after (one bf16 flash launch per attention layer, one
    scan launch per mamba layer, nothing else), then HYBRID_DECODES decode
    steps from an empty cache (no kernel launch), every logit finite; the
    bf16 flash kernel on the captured q / k / v with its dropped-tile
    controls, and the scan on the captured inputs within SCAN_TOL x max(1,
    max |y|).  Returns the numbers printed."""
    torch.cuda.reset_peak_memory_stats()
    cfg, model, init_s = full_width(base, HYBRID_DEPTHS[base.name])
    n_params = sum(p.numel() for p in model.parameters())
    tokens = session_prompt("s0", cfg.vocab)
    prefill = make_prefill_step(cfg, impl="flash")
    fcap, scap = FlashCapture(cfg), ScanCapture()
    fa.flash_attention, ms.selective_scan = fcap, scap
    for k in ALL_KERNELS:
        k.launches = 0
    try:
        logits = prefill(model, {"tokens": tokens})
    finally:
        fa.flash_attention, ms.selective_scan = fcap.kernel, scap.kernel
    n_attn = attention_layers(cfg)
    want = {k.name: 0 for k in ALL_KERNELS}
    want.update(flash_attention_bf16=n_attn,
                selective_scan=cfg.n_layers - n_attn)
    finite = bool(torch.isfinite(logits).all())
    cache = init_cache(cfg, 1, MAX_LEN)
    tok = tokens[:, -1:]
    decode_ms = []
    for _ in range(HYBRID_DECODES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out, cache = model_decode_step(cfg, model, cache, tok)
        tok = out.argmax(-1, keepdim=True)
        finite &= bool(torch.isfinite(out).all())
        decode_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k.name: k.launches for k in ALL_KERNELS}
    if launches != want or not finite:
        raise AssertionError(f"{cfg.name} with {cfg.n_layers} layers: "
                             f"launches {launches} (want {want}) over one "
                             f"prefill and {HYBRID_DECODES} decodes, logits "
                             f"finite: {finite}")
    flash = {}
    for kind, (q, k, v, causal, window) in sorted(fcap.seen.items()):
        err, checks = compare_flash(q, k, v, causal, window)
        flash[kind] = {"q": list(q.shape), "kv_heads": k.shape[2],
                       "max_abs_err": err, "checks": checks}
    fcap.seen.clear()
    scan = None
    if scap.first is not None:
        dt, x, b, c, a = scap.first
        err, top, median = compare_scan(dt, x, b, c, a, relative=True)
        scan = {"dt": list(dt.shape), "max_abs_err": err,
                "tolerance": SCAN_TOL * max(1.0, top),
                "median_abs_output": median}
        scap.first = None
    prefill_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(model, {"tokens": tokens})
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    return {"model": cfg.name, "layers": [
                f"{layer.kind}+{layer.ffn_kind}" for layer in model.layers],
            "params_b": n_params / 1e9, "init_s": init_s,
            "launches": launches, "flash_vs_plain": flash,
            "scan_vs_plain": scan,
            "prefill_ms": prefill_ms,
            "prefill_tokens_per_s_median":
                PROMPT / statistics.median(prefill_ms) * 1e3,
            "decode_ms": decode_ms,
            "decode_ms_per_token_median": statistics.median(decode_ms[1:]),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def model_f32(base, n_layers: int, seed: int) -> dict:
    """Phases 10, 15 and 16's float32 check: ``base`` at full width with
    ``n_layers`` layers (each side, for the enc-dec family) in float32
    (:func:`full_width`, weights drawn from ``seed``), the logits at every
    position of an F32_PROMPT-token prefill (of F32_PROMPT seeded frames
    and as many target tokens, for the enc-dec family) through the kernels
    (the float32 flash kernel on every attention call, the scan on mamba
    layers) against the same model with both entries on their plain
    versions, on the same card and weights, within SCAN_TOL x max(1, max
    |logit|), each kernel launched once per call of its kind and no other
    kernel.  Returns the numbers printed."""
    torch.cuda.reset_peak_memory_stats()
    cfg, model, _ = full_width(base, n_layers, "float32", seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, F32_PROMPT),
                                     generator=g, device="cuda")}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((1, F32_PROMPT, cfg.frontend_dim),
                                      generator=g, device="cuda")

    def logits():
        with torch.no_grad():
            return lm_logits(cfg, model,
                             model_forward(cfg, model, batch, impl="flash"))

    for k in ALL_KERNELS:
        k.launches = 0
    kern = logits()
    launches = {k.name: k.launches for k in ALL_KERNELS}
    flash, scan = fa.flash_attention, ms.selective_scan
    fa.flash_attention = fa.flash_attention_ref
    ms.selective_scan = functools.partial(scan, backend="ref")
    try:
        plain = logits()
    finally:
        fa.flash_attention, ms.selective_scan = flash, scan
    torch.cuda.synchronize()
    err = max_abs_err(kern, plain)
    top = float(plain.abs().max())
    want = {k.name: 0 for k in ALL_KERNELS}
    want.update(flash_attention=flash_calls(cfg),
                selective_scan=cfg.n_layers - attention_layers(cfg))
    if not err <= SCAN_TOL * max(1.0, top) or launches != want:
        raise AssertionError(f"float32 {cfg.name}: kernels vs plain logits "
                             f"differ by {err} (bound {SCAN_TOL} x max(1, "
                             f"{top})), launches {launches}")
    return {"model": cfg.name, "layers": cfg.n_layers, "S": F32_PROMPT,
            "max_abs_err": err, "max_abs_logit": top,
            "tolerance": SCAN_TOL * max(1.0, top), "launches": launches,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


# --------------------------------------------------------------------------- #
# 16. the enc-dec and vlm serving paths
# --------------------------------------------------------------------------- #

ENCDEC_F32_LAYERS = 2  # a side
VLM_LAYERS = 4  # of internvl2-76b's 80: 11.2 GB at full width


def encdec_vlm_path(flash_base=None) -> dict:
    """Phase 16: seamless-m4t-large-v2 whole behind ``serve.Engine``
    (:func:`serving_path`: 72 bf16 flash launches a prefill, 24 encoder,
    24 decoder self and 24 cross, flash held to its plain version on the
    first call of each), bf16 flash timed at its shape (1, PROMPT / 2, 16,
    16, 64) non-causal and causal (beside ``flash_base``, an earlier
    kernel, in turns, when given), its float32 check at two layers a side
    (:func:`model_f32`); then internvl2-76b at full width with VLM_LAYERS
    layers behind the same engine (patches and text, one flash launch a
    layer and prefill).  Returns the numbers printed."""
    out = {}
    launches, err, f32, serving = serving_path(SEAMLESS_M4T_LARGE_V2)
    out["seamless"] = {"launches": launches, "flash_bf16_err": err,
                       "flash_f32_err": f32, "serving": serving}
    gc.collect()
    torch.cuda.empty_cache()
    cfg = SEAMLESS_M4T_LARGE_V2
    shape = (1, PROMPT // 2, cfg.n_heads, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    out["flash_times"] = {
        name: time_flash(torch.bfloat16, None, seed=seed, shape=shape,
                         causal=causal, baseline=flash_base)
        for name, causal, seed in (("noncausal", False, 21),
                                   ("causal", True, 22))}
    out["seamless_f32"] = model_f32(cfg, ENCDEC_F32_LAYERS, seed=3)
    gc.collect()
    torch.cuda.empty_cache()
    vlm = dataclasses.replace(INTERNVL2_76B, n_layers=VLM_LAYERS)
    launches, err, f32, serving = serving_path(vlm)
    out["internvl2"] = {"launches": launches, "flash_bf16_err": err,
                        "flash_f32_err": f32, "serving": serving}
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- #
# 17. training on the card
# --------------------------------------------------------------------------- #

TRAIN_SEQ = 1024
TRAIN_STEPS = 4
RESTART_AT = 2
TRAIN_REMAT = "none"
#: the AdamW update's bytes a parameter: p, g (bf16) and m, v (float32)
#: read, p, m, v written
UPDATE_BYTES = 2 + 2 + 4 + 4 + 2 + 4 + 4
TRAIN_F32 = dict(batch=4, seq=256)
#: a train step's peak counted on ``meta`` against the card's measured
#: ``max_memory_allocated``: within 5% either way
PEAK_TOL = 0.05


def train_batch(cfg, B: int, S: int, step: int) -> dict:
    return batch_to(make_batch(cfg, B, S, step), "cuda")


def train_steps(step, model, opt, batches):
    """Run ``step`` over ``batches``; returns the model, the optimizer
    state, the losses, the grad norms, each step's ms (host clock,
    synchronised) and each step's device memory: the bytes allocated
    just before it and its peak (``max_memory_allocated`` after
    ``reset_peak_memory_stats`` right before it)."""
    losses, gnorms, ms, mem = [], [], [], []
    for b in batches:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model, opt, m = step(model, opt, b)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        mem.append({"allocated_before": before,
                    "peak": torch.cuda.max_memory_allocated()})
    return model, opt, losses, gnorms, ms, mem


def train_step_counted(cfg, ocfg, batch) -> dict:
    """One ``make_train_step`` step of ``cfg`` counted on the ``meta``
    device (nothing runs) with the arguments a card step holds live: the
    parameters, AdamW's state and ``batch``'s shapes.  Returns the
    counter's flops and bytes, its ``memory`` record (the dry run's keys)
    and the seconds the count took."""
    model = params_shape(cfg)
    opt = adamw.init(ocfg, dict(model.named_parameters()))
    args = (model, opt, {k: torch.empty_like(v, device="meta")
                         for k, v in batch.items()})
    t0 = time.perf_counter()
    with OpCounter(hold=args) as counter:
        out = make_train_step(cfg, ocfg)(*args)
    return {"counts": counter.counts(), "memory": counter.memory(out),
            "count_s": time.perf_counter() - t0}


def train_step_split(cfg, ocfg, model, opt, batch, reps: int = 2) -> dict:
    """Where a train step's time goes: ``make_train_step``'s three stages
    run one by one, synchronised (the loss through ``model_loss``, its
    ``torch.autograd`` gradients, ``adamw.update``), median host ms of
    ``reps`` runs.  Each run moves the parameters, as a step does.  The
    mamba layers take the train path's differentiable scan."""
    params = dict(model.named_parameters())
    ms = collections.defaultdict(list)
    for _ in range(reps):
        for p in params.values():
            p.requires_grad_(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = model_loss(cfg, model, batch, scan_impl="chunked")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(loss, list(params.values()))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for p in params.values():
            p.requires_grad_(False)
        adamw.update(ocfg, params, dict(zip(params, grads)), opt)
        del grads
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for key, a, b in (("forward", t0, t1), ("backward", t1, t2),
                          ("optimizer", t2, t3)):
            ms[f"{key}_ms"].append((b - a) * 1e3)
    return {k: statistics.median(v) for k, v in ms.items()}


def train_whole(base, n_layers: int = None, remat: str = TRAIN_REMAT) -> dict:
    """``base`` in bf16 on the card (whole, or its first ``n_layers``
    layers at full width), TRAIN_STEPS steps of
    ``make_train_step`` at AdamW's defaults on ``make_batch``'s batches (B
    = 1, S = TRAIN_SEQ), every launch counter set to 0 just before and read
    just after: finite losses and grad norms, a gradient for every
    parameter (a non-zero first moment), every weight matrix moved, no
    kernel launched.  Then where a step goes (:func:`train_step_split`,
    and the profiler's idle share) and its bound: 6 x parameters x tokens
    flops at the bf16 peak, then the update's UPDATE_BYTES a parameter
    over HBM.

    Before the steps, one step of the same configuration is counted on
    ``meta`` (:func:`train_step_counted`); each step's measured peak must
    lie within PEAK_TOL of the counted one.  Returns the numbers
    printed."""
    cfg = dataclasses.replace(base, remat=remat,
                              n_layers=n_layers or base.n_layers)
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator(device="cuda").manual_seed(21),
                       device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    ocfg = adamw.AdamWConfig()
    opt = adamw.init(ocfg, params)
    before = {k: p.detach().to("cpu", copy=True) for k, p in params.items()}
    step = make_train_step(cfg, ocfg)
    batches = [train_batch(cfg, 1, TRAIN_SEQ, i) for i in range(TRAIN_STEPS)]
    counted = train_step_counted(cfg, ocfg, batches[0])
    for k in ALL_KERNELS:
        k.launches = 0
    model, opt, losses, gnorms, step_ms, mem = train_steps(step, model, opt,
                                                           batches)
    launches = {k.name: k.launches for k in ALL_KERNELS}
    peak = counted["memory"]["peak_bytes"]
    ratios = [peak / m["peak"] for m in mem]
    if not all(abs(r - 1) <= PEAK_TOL for r in ratios):
        raise AssertionError(f"training {cfg.name}: the peak counted on meta"
                             f" {counted['memory']}, measured {mem}: counted"
                             f" / measured {ratios}, beyond {PEAK_TOL}")
    peak_gb = max(m["peak"] for m in mem) / 1e9
    finite = all(math.isfinite(x) for x in losses + gnorms)
    # a zero-width FFN (falcon-mamba's d_ff = 0) has empty leaves, and the
    # norm before it feeds nothing else: no gradient reaches them
    inert = {k for k, p in params.items() if p.numel() == 0}
    if cfg.d_ff == 0:
        inert |= {k for k in params if re.fullmatch(r"layers\.\d+\.ln2\.\w+",
                                                    k)}
    still = [k for k, p in model.named_parameters()
             if k not in inert and torch.equal(p.detach().cpu(), before[k])]
    no_grad = [k for k, m in opt["m"].items()
               if k not in inert and not bool(m.any())]
    del before
    # a bf16 leaf moves only where lr x its update passes half a bf16 ulp:
    # the norm gains, all 1.0 (ulp 2^-7), do not at the warm-up's rates;
    # every weight matrix must move, and every leaf must have had a
    # gradient (a non-zero first moment)
    if not finite or no_grad or any(p.dim() > 1 for k, p in params.items()
                                    if k in still) or any(launches.values()):
        raise AssertionError(f"training {cfg.name}: losses {losses}, grad "
                             f"norms {gnorms}, parameters that did not move "
                             f"{still[:5]} ({len(still)}), with no gradient "
                             f"{no_grad[:5]} ({len(no_grad)}), launches "
                             f"{launches}")
    split = train_step_split(cfg, ocfg, model, opt, batches[0])
    breakdown = device_breakdown(lambda: step(model, opt, batches[0]),
                                 "\0", "none", iters=2)
    t_ops = 6 * n_params * TRAIN_SEQ / BF16_FLOPS_PER_S * 1e3
    t_bytes = UPDATE_BYTES * n_params / HBM_BYTES_PER_S * 1e3
    tail = statistics.median(step_ms[1:])
    return {"model": cfg.name, "layers": cfg.n_layers, "remat": cfg.remat,
            "params_b": n_params / 1e9, "init_s": init_s,
            "batch": [1, TRAIN_SEQ], "losses": losses, "grad_norms": gnorms,
            "step_ms": step_ms, "step_ms_median_after_first": tail,
            "tokens_per_s": TRAIN_SEQ / tail * 1e3, "peak_gb": peak_gb,
            "memory": {"counted": counted["memory"],
                       "count_s": counted["count_s"], "measured": mem,
                       "counted_over_measured_peak": ratios},
            "counts": counted["counts"],
            "launches": launches, "unmoved_leaves": len(still),
            "inert_leaves": len(inert),
            "unmoved_leaf_kinds": sorted({k.rsplit(".", 1)[-1]
                                          for k in still}),
            "leaves": len(params), "split": split,
            "breakdown": breakdown, "bound_ms": t_ops + t_bytes,
            "bound_ops_ms": t_ops, "bound_update_bytes_ms": t_bytes,
            "step_over_bound": tail / (t_ops + t_bytes)}


def peak_line(whole: dict, tag: str) -> str:
    """The line that sets :func:`train_whole`'s counted peak beside the
    card's measured ones."""
    m = whole["memory"]
    c = m["counted"]
    return (f"train-step memory {tag}: {whole['model']} ({whole['layers']} "
            f"layers, remat {whole['remat']}): counted on meta in "
            f"{m['count_s']:.1f} s: peak {c['peak_bytes']} B, arguments "
            f"{c['argument_bytes']} B, temp {c['temp_bytes']} B, output "
            f"{c['output_bytes']} B, written in place {c['alias_bytes']} B; "
            f"measured, a step: peak {[x['peak'] for x in m['measured']]} B, "
            f"allocated before {[x['allocated_before'] for x in m['measured']]}"
            f" B; counted / measured peak "
            f"{[round(r, 6) for r in m['counted_over_measured_peak']]} "
            f"(within {PEAK_TOL})")


def train_restart(base) -> dict:
    """Crash-restart at full width with one local:global period of
    ``base`` (6 layers, bf16): TRAIN_STEPS steps straight, then RESTART_AT
    steps, a blocking save through ``CheckpointManager`` into a temporary
    directory (removed after), a model and optimizer state rebuilt from
    other seeds and restored from it, and the remaining steps.  The losses
    and every parameter must be bit-identical.  Returns the numbers
    printed."""
    cfg = dataclasses.replace(base, n_layers=base.period, remat="none")
    ocfg = adamw.AdamWConfig()
    step = make_train_step(cfg, ocfg)
    batches = [train_batch(cfg, 1, TRAIN_SEQ, i) for i in range(TRAIN_STEPS)]

    def fresh(seed: int):
        model = init_model(cfg, torch.Generator(device="cuda")
                           .manual_seed(seed), device="cuda")
        return model, adamw.init(ocfg, dict(model.named_parameters()))

    model, opt = fresh(31)
    model, opt, straight, *_ = train_steps(step, model, opt, batches)
    want = {k: p.detach().clone() for k, p in model.named_parameters()}
    del model, opt
    model, opt = fresh(31)
    model, opt, first, *_ = train_steps(step, model, opt,
                                        batches[:RESTART_AT])
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        mgr = CheckpointManager(d)
        t0 = time.perf_counter()
        mgr.save(RESTART_AT, train_state(model, opt))
        save_s = time.perf_counter() - t0
        ckpt_gb = sum(f.stat().st_size for f in Path(d).rglob("*")
                      if f.is_file()) / 1e9
        del model, opt
        gc.collect()
        model, opt = fresh(32)  # other weights: the restore overwrites them
        t0 = time.perf_counter()
        opt = load_train_state(model,
                               mgr.restore(train_state(model, opt)))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    model, opt, second, *_ = train_steps(step, model, opt,
                                         batches[RESTART_AT:])
    differ = [k for k, p in model.named_parameters()
              if not torch.equal(p, want[k])]
    if first + second != straight or differ or Path(d).exists():
        raise AssertionError(f"restart of {cfg.name} ({cfg.n_layers} layers)"
                             f": losses {straight} straight, {first} + "
                             f"{second} restarted; parameters that differ "
                             f"{differ[:5]} ({len(differ)})")
    return {"model": cfg.name, "layers": cfg.n_layers, "losses": straight,
            "restarted_at": RESTART_AT, "checkpoint_gb": ckpt_gb,
            "save_s": save_s, "restore_s": restore_s,
            "bit_identical": True}


def train_f32_vs_cpu(base) -> dict:
    """``base`` reduced, in float32 (TF32 off): one train step and the
    gradients of one loss on the card against the same on the CPU, from the
    same weights and batch: loss and grad norm within 1e-5 relative, each
    parameter's gradient within 1e-4 of that leaf's largest |g|.  Returns
    the numbers printed."""
    cfg = dataclasses.replace(base.reduced(), remat="none")
    cpu = init_model(cfg, torch.Generator().manual_seed(41), device="cpu")
    card = copy.deepcopy(cpu).to("cuda")
    b = make_batch(cfg, TRAIN_F32["batch"], TRAIN_F32["seq"], 0)

    def grads(model, dev):
        params = dict(model.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
        loss = model_loss(cfg, model, batch_to(b, dev), scan_impl="chunked")
        g = torch.autograd.grad(loss, list(params.values()))
        for p in params.values():
            p.requires_grad_(False)
        return float(loss.detach()), {k: x.cpu() for k, x in zip(params, g)}

    (loss_c, g_c), (loss_g, g_g) = grads(cpu, "cpu"), grads(card, "cuda")
    worst = max(float((g_g[k] - g).abs().max())
                / max(float(g.abs().max()), 1e-30) for k, g in g_c.items())
    ocfg = adamw.AdamWConfig()
    metrics = {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        _, _, m = make_train_step(cfg, ocfg)(
            model, adamw.init(ocfg, dict(model.named_parameters())),
            batch_to(b, dev))
        metrics[dev] = {k: float(v) for k, v in m.items()}
    rel = {k: abs(metrics["cuda"][k] - metrics["cpu"][k])
           / abs(metrics["cpu"][k]) for k in ("loss", "grad_norm")}
    rel["loss_grad_call"] = abs(loss_g - loss_c) / abs(loss_c)
    if max(rel.values()) > 1e-5 or worst > 1e-4:
        raise AssertionError(f"float32 train step of {cfg.name}: card vs "
                             f"cpu relative differences {rel}, worst "
                             f"gradient {worst} x its leaf's max |g|")
    return {"model": cfg.name, "layers": cfg.n_layers,
            "batch": [TRAIN_F32["batch"], TRAIN_F32["seq"]],
            "relative_err": rel, "worst_grad_err_over_leaf_max": worst,
            "metrics": metrics}


def train_path() -> dict:
    """Phase 17, under ``torch.use_deterministic_algorithms(True)``:
    :func:`train_whole`, :func:`train_restart` and
    :func:`train_f32_vs_cpu` on gemma3-4b, no kernel launched in any."""
    torch.use_deterministic_algorithms(True)
    try:
        for k in ALL_KERNELS:
            k.launches = 0
        out = {"whole": train_whole(GEMMA3_4B)}
        gc.collect()
        torch.cuda.empty_cache()
        out["restart"] = train_restart(GEMMA3_4B)
        gc.collect()
        torch.cuda.empty_cache()
        out["float32_vs_cpu"] = train_f32_vs_cpu(GEMMA3_4B)
        launches = {k.name: k.launches for k in ALL_KERNELS}
        if any(launches.values()):
            raise AssertionError(f"the training phase launched {launches}")
    finally:
        torch.use_deterministic_algorithms(False)
    return out


# --------------------------------------------------------------------------- #
# 18. the mesh and roofline tooling
# --------------------------------------------------------------------------- #

#: phase 18(a)'s dry runs at full size: (arch, shape, mesh); each traces one
#: step on fake ranks of the (32, 8) or (2, 32, 8) mesh on the host's CPU.
#: The last three each exercise one kind of repair: decode with 4 kv heads
#: under a model axis of 8, the MoE routing's zeros at the local group
#: count, the MoE reshape of a batch of 32 over 64 data ranks
DRYRUNS = [("gemma3-4b", "train_4k", "single"),
           ("falcon-mamba-7b", "prefill_32k", "single"),
           ("gemma3-4b", "train_4k", "multi"),
           ("gemma3-4b", "decode_32k", "single"),
           ("qwen3-moe-30b-a3b", "prefill_32k", "single"),
           ("arctic-480b", "prefill_32k", "multi")]
#: the cells whose per-device peak must stay under CARD_BYTES: all but
#: arctic-480b prefill_32k on (2, 32, 8), whose batch of 32 the reference's
#: specs replicate over the 64 data ranks (the whole [32, 32768, 7168]
#: hidden state on every device)
DRYRUN_FITS = {cell for cell in DRYRUNS
               if cell != ("arctic-480b", "prefill_32k", "multi")}
DRYRUN_TIMEOUT = 900
CARD_BYTES = 80e9
#: the memory record of a dry run, the reference's keys
DRYRUN_MEMORY = {"argument_bytes", "output_bytes", "temp_bytes",
                 "peak_bytes", "alias_bytes"}
#: phase 18(c)'s depth: one local:global period of gemma3-4b at full width
DTENSOR_LAYERS = 6
#: phase 17's hand-worked bound of the gemma3-4b train step (PERF.md §5)
TRAIN_HAND_BOUND_MS = 49.58


def start_dryruns(out: Path) -> dict:
    """Phase 18(a): ``python -m repro_torch.launch.dryrun`` for each of
    DRYRUNS, one subprocess each, all started at once in the background
    (they run on the host's CPU and touch nothing on the card but a
    context); their records and logs land in ``out``.  Every process is
    stopped at exit."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {}
    for arch, shape, mesh in DRYRUNS:
        with open(out / f"{arch}_{shape}_{mesh}.log", "w") as log:
            procs[(arch, shape, mesh)] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--mesh", mesh, "--device", "cuda",
                 "--out", str(out)], cwd=ROOT, env=env, stdout=log,
                stderr=subprocess.STDOUT)
    atexit.register(lambda: [p.kill() for p in procs.values()
                             if p.poll() is None])
    return procs


def collect_dryruns(procs: dict, out: Path, started: float) -> dict:
    """Phase 18(a)'s records: each dry run must exit 0 with ``status:
    ok``, positive flops, per-device argument bytes under the card's 80 GB
    and the reference's memory keys counted (DRYRUN_MEMORY: a peak that
    holds the arguments, temporaries its rest), and the cells of
    DRYRUN_FITS a per-device peak under it too.  Returns, per cell, the
    roofline terms, the counts and the memory."""
    recs = {}
    for (arch, shape, mesh), p in procs.items():
        left = DRYRUN_TIMEOUT - (time.perf_counter() - started)
        try:
            rc = p.wait(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            p.kill()
            rc = None
        path = out / f"{arch}_{shape}_{mesh}.json"
        rec = json.loads(path.read_text()) if path.exists() else {}
        mem = rec.get("memory", {})
        if rc != 0 or rec.get("status") != "ok" \
                or not rec["loop_aware"]["flops_per_device"] > 0 \
                or not mem["argument_bytes"] < CARD_BYTES \
                or set(mem) != DRYRUN_MEMORY \
                or not mem["peak_bytes"] >= mem["argument_bytes"] > 0 \
                or mem["temp_bytes"] != max(0, mem["peak_bytes"]
                                            - mem["argument_bytes"]
                                            - mem["output_bytes"]) \
                or ((arch, shape, mesh) in DRYRUN_FITS
                    and not mem["peak_bytes"] < CARD_BYTES):
            log = (out / f"{arch}_{shape}_{mesh}.log").read_text()
            raise AssertionError(f"dry run {arch} {shape} {mesh}: exit "
                                 f"{rc}, memory {mem}, "
                                 f"{rec.get('traceback', log)[-3000:]}")
        recs[f"{arch} {shape} {rec['mesh']}"] = {
            key: rec[key] for key in (
                "n_chips", "fsdp", "trace_s", "roofline", "loop_aware",
                "memory", "collective_link_bytes_by_axis",
                "model_flops_per_device", "useful_flops_ratio")}
    return recs


def _median_ms(fn, reps: int = 3) -> list:
    """``fn()``'s host ms, synchronised, ``reps`` times."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def oracle_vs_card(base, seed: int, **step_kw) -> dict:
    """Phase 18(b), one model: ``base`` whole in bf16, one prefill of
    PROMPT tokens (B = 1) through ``make_prefill_step(**step_kw)``, priced
    by ``RooflineOracle.add_module`` at the H100's peaks (the counter runs
    the prefill on the card and counts its ops), then the same prefill
    timed.  The measured time must be at or above the bound: a card that
    beats it means the count is wrong."""
    cfg, model, _ = full_width(base, base.n_layers, seed=seed)
    batch = {"tokens": session_prompt("s0", cfg.vocab)}
    step = make_prefill_step(cfg, **step_kw)
    oracle = RooflineOracle(peak_flops_s=PEAK_FLOPS_BF16,
                            peak_bytes_s=HBM_BW)
    with OpCounter() as counter:  # the oracle's own counts, to print
        bound_ms = oracle.add_module(cfg.name, step, model, batch) * 1e3
    counts = counter.counts()
    times = _median_ms(lambda: step(model, batch))
    measured = statistics.median(times)
    if not min(times) >= bound_ms:
        raise AssertionError(f"{cfg.name} prefill: {times} ms, below the "
                             f"oracle's bound {bound_ms} ms {counts}")
    del model
    return {"model": cfg.name, "layers": cfg.n_layers, "tokens": PROMPT,
            "step": {k: v for k, v in step_kw.items()}, "counts": counts,
            "bound_ms": bound_ms,
            "bound_by": "operations" if counts["flops"] / PEAK_FLOPS_BF16
            >= counts["bytes"] / HBM_BW else "bytes",
            "ms": times, "ms_over_bound": measured / bound_ms}


def train_step_counted_bound(whole: dict) -> dict:
    """Phase 17's gemma3-4b train step (B = 1, S = TRAIN_SEQ, no remat,
    AdamW's defaults) as :func:`train_whole` counted it on the ``meta``
    device (``whole``, its result), priced at the H100's peaks, beside the
    hand-worked bound."""
    counts = whole["counts"]
    oracle = RooflineOracle(peak_flops_s=PEAK_FLOPS_BF16,
                            peak_bytes_s=HBM_BW)
    return {"model": whole["model"], "batch": whole["batch"],
            "counts": counts,
            "counted_bound_ms": oracle.add_counts(
                "train", counts["flops"], counts["bytes"]) * 1e3,
            "hand_worked_bound_ms": TRAIN_HAND_BOUND_MS}


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def dtensor_prefill(base) -> dict:
    """Phase 18(c): a one-rank NCCL process group, a (1, 1) ``DeviceMesh``
    on the card, ``base`` with DTENSOR_LAYERS layers at full width (bf16):
    one prefill of PROMPT tokens with its parameters and batch distributed
    by the specs and run under the activation rules, against the same
    prefill with plain tensors and no rules: the logits bit for bit (under
    deterministic algorithms)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    dist.init_process_group("nccl", init_method="tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    torch.use_deterministic_algorithms(True)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        cfg, model, _ = full_width(base, DTENSOR_LAYERS, seed=23)
        batch = {"tokens": session_prompt("s1", cfg.vocab)}
        step = make_prefill_step(cfg)
        want = step(model, batch)
        pspecs = sh.param_specs(dict(model.named_parameters()), mesh,
                                fsdp=False)
        for name, p in list(model.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            setattr(model.get_submodule(owner), leaf, torch.nn.Parameter(
                distribute_tensor(p, mesh, sh.to_placements(pspecs[name],
                                                            mesh)),
                requires_grad=False))
        bspec = sh.batch_specs(batch, mesh, batch=1)["tokens"]
        dbatch = {"tokens": distribute_tensor(
            batch["tokens"], mesh, sh.to_placements(bspec, mesh))}
        with sharding_rules(sh.activation_rules(cfg, mesh, batch=1)), \
                implicit_replication():
            got = step(model, dbatch).full_tensor()
        equal = torch.equal(got, want)
        if not equal:
            raise AssertionError(f"{cfg.name} ({cfg.n_layers} layers) on a "
                                 f"(1, 1) mesh: logits differ by "
                                 f"{float((got - want).abs().max())}")
        return {"model": cfg.name, "layers": cfg.n_layers, "mesh": [1, 1],
                "backend": "nccl", "logits": list(got.shape),
                "bit_identical": equal}
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()


# --------------------------------------------------------------------------- #
# 19. training of the ssm and hybrid families
# --------------------------------------------------------------------------- #

#: falcon-mamba-7b's depth in phase 19(a).  Whole, its 7.27 B parameters at
#: 12 bytes (bf16 weights and gradients, float32 moments) are 87 GB, over
#: the card's 80 GB.  A layer holds 105.3 M parameters (1.26 GB of state);
#: the embedding and head 0.53 B (6.4 GB); the recompute of one layer's
#: chunked scan (4 chunks of [1, 256, 8192, 16] float32 intermediates and
#: their gradients) an estimated 15-20 GB.  A first run at 32 layers (3.90
#: B parameters) peaked at 57.58 GB; each further layer adds 1.26 GB, so
#: 40 layers (4.74 B parameters, 56.9 GB of state) peak near 67.7 GB and
#: leave about 12 GB of the card.
SSM_TRAIN_LAYERS = 40


def jamba_full_width_finding(base) -> dict:
    """Phase 19(c): jamba at full width does not train on one card.  Its
    smallest full-width cut that holds a mamba layer is one attention and
    one mamba layer (phase 15's 2 layers): their parameters at 8 bytes (the
    least: bf16 weights, gradients and both moments) against 80 GB."""
    cfg = dataclasses.replace(base, n_layers=2)
    total, _ = param_counts(cfg)
    return {"model": base.name, "layers": 2, "params_b": total / 1e9,
            "state_gb_at_8_bytes": 8 * total / 1e9,
            "fits": 8 * total < CARD_BYTES,
            "finding": "waits for a multi-chip cell"}


def ssm_train_path() -> dict:
    """Phase 19, under ``torch.use_deterministic_algorithms(True)``:
    falcon-mamba-7b at full width with SSM_TRAIN_LAYERS layers (bf16, B =
    1, S = TRAIN_SEQ, ``remat="full"``) through :func:`train_whole`;
    reduced falcon-mamba-7b and jamba in float32, card vs CPU
    (:func:`train_f32_vs_cpu`); jamba's full-width finding.  No kernel may
    launch: the scan kernel's counter stays at 0 throughout."""
    torch.use_deterministic_algorithms(True)
    try:
        for k in ALL_KERNELS:
            k.launches = 0
        out = {"whole": train_whole(FALCON_MAMBA_7B, SSM_TRAIN_LAYERS,
                                    remat="full")}
        gc.collect()
        torch.cuda.empty_cache()
        for base in (FALCON_MAMBA_7B, JAMBA_15_LARGE):
            out[f"float32_vs_cpu {base.name}"] = train_f32_vs_cpu(base)
        launches = {k.name: k.launches for k in ALL_KERNELS}
        if any(launches.values()):
            raise AssertionError(f"the ssm training phase launched "
                                 f"{launches}")
        out["launches"] = launches
    finally:
        torch.use_deterministic_algorithms(False)
    out["jamba_full_width"] = jamba_full_width_finding(JAMBA_15_LARGE)
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


def traced_twin(replicas: int, duration: float, trace,
                **platform_kw) -> dict:
    """Run A on a twin (``device="cpu"`` or ``backend="np"``), in a process
    of its own: what :func:`check_traced` compares, the wall seconds and
    the decisions."""
    out = traced_run(replicas, duration, trace, **platform_kw)[1]()
    run = out["run"]
    return {"records": run.records, "rng_tail": run.rng_tail,
            "jsonl": run.jsonl, "wall_s": out["wall_s"],
            "decisions": out["decisions"]}


def check_traced(out, twins) -> dict:
    """Run A's checks: records equal to each twin's (NaN-aware), rng tails
    equal, the tracer's jsonl byte-equal to the first twin's, the Chrome
    trace valid, work conserved per worker, the outage fired, and every
    activation the outage lost either retried or counted lost for good."""
    run, sim, res = out["run"], out["sim"], out["res"]
    for name, twin in twins.items():
        if not records_equal(run.records, twin["records"]):
            raise AssertionError(f"run A's records differ from the {name} "
                                 "twin's")
        if run.rng_tail != twin["rng_tail"]:
            raise AssertionError(f"run A's rng tail differs from the {name} "
                                 "twin's")
    first = next(iter(twins.values()))
    if run.jsonl != first["jsonl"]:
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
    run again under the profiler.  The twins run in processes of their
    own, beside the runs on ``device``.  Returns the numbers printed."""
    duration, trace = poisson_window(replicas, min_arrivals)
    waves = wave_trace(ticks, per_tick)
    with host_processes(4) as pool:
        twins = {name: pool.submit(traced_twin, replicas, duration, trace,
                                   **kw)
                 for name, kw in (("cpu", {"device": "cpu"}),
                                  ("np", {"backend": "np"}))}
        b_twins = {name: pool.submit(wave_run, replicas, waves,
                                     batched=True, **kw)
                   for name, kw in (("cpu", {"device": "cpu"}),
                                    ("np", {"backend": "np"}))}
        a_out = traced_path_a(replicas, duration, trace, device, twins,
                              min_arrivals)
        b_out = wave_path_b(replicas, waves, device, b_twins, ticks,
                            per_tick)
    return {"A": a_out, "B": b_out}


def traced_path_a(replicas, duration, trace, device, twins,
                  min_arrivals) -> dict:
    """Phase 12's run A: per arrival, traced, with resilience and an
    outage, on ``device`` against its twins (futures)."""
    workers = 6 * replicas
    on_card = torch.device(device).type == "cuda"
    _sim, drive = traced_run(replicas, duration, trace, device=device)
    for k in KERNELS:
        k.launches = 0
    a = drive()
    a_launches = {k.name: k.launches for k in KERNELS}
    twins = {name: f.result() for name, f in twins.items()}
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
    return a_out


def wave_path_b(replicas, waves, device, twins, ticks, per_tick) -> dict:
    """Phase 12's run B, same-tick waves through the fused bulk pass,
    untraced, on ``device`` against its twins (futures)."""
    workers = 6 * replicas
    on_card = torch.device(device).type == "cuda"
    for k in KERNELS:
        k.launches = 0
    b = wave_run(replicas, waves, batched=True, device=device)
    b_launches = {k.name: k.launches for k in KERNELS}
    seq = wave_run(replicas, waves, batched=False, device=device)
    cpu, twin = (twins[name].result() for name in ("cpu", "np"))
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
    return b_out


# --------------------------------------------------------------------------- #
# 13. the forecast plug-in on the decision path: the predictive trace
# --------------------------------------------------------------------------- #

# benchmarks/coldstart.py's predictive column, not cut: its script (i affine
# to d), keep-alive policy, pool, forecast and planner knobs, on phase 12's
# cluster at coldstart's rate a replica
PRED_SCRIPT = """
api:
  workers: *
  strategy: random
img:
  workers: *
  strategy: random
etl:
  workers: *
  strategy: random
d:
  workers: *
  strategy: random
i:
  workers: *
  strategy: random
  affinity: [d]
"""
PRED_RATE = 2.0  # arrivals/s a replica (coldstart.py's RATE)
PRED_TAU = 20.0
PLAN_INTERVAL = 1.0
MIGRATE_COST = 0.25
# the chained scenario (divide-et-impera roots, two impera children each):
# its DAG-successor forecast drives the planner's prewarms and migrations
# from the first epoch on, where poisson issues none (coldstart.py's own
# poisson column: 0 prewarms over 3 seeds of 150 s, BENCH_coldstart.json)
PRED_SCENARIO = "chained"
# the window of roots is cut, never the rate or the cluster, to 1.25 s, so
# that roots still arrive after the first planning epoch; the run stops
# half an interval after its second epoch.  At 16,386 workers the host time
# of a decision and of an epoch grows with the pool's containers
# (WarmPool.used_mb scans the busy containers and idle keys for each
# worker): a 2.0 s window took 6, 62 and 126 s of epochs and 7 ms a
# decision besides, the whole script 1,650 s on an H100; and the predictive
# keep-alive would keep the planner epoching for about a hundred simulated
# seconds after the window.  A third epoch took 21-48 s of host time on an
# H100's host, in each of three runs (the card run and its two twins)
PRED_WINDOW = 1.25
PRED_EPOCHS = 2


class Horizon(Exception):
    """Raised by the event that ends a predictive run."""


def _stop():
    raise Horizon


class CheckedPlanner(ForecastPlanner):
    """The forecast planner with each epoch's host seconds kept and every
    prewarm and migration target held to the port's scalar Listing-1
    ``valid`` on the state the epoch planned on (as
    ``tests/test_forecast.py``'s planner is)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.epoch_s, self.actions = [], []

    def plan(self, conf, pool, now):
        t0 = time.perf_counter()
        actions = super().plan(conf, pool, now)
        self.epoch_s.append(time.perf_counter() - t0)
        for a in actions:
            target = a.worker if isinstance(a, Prewarm) \
                else getattr(a, "dst", None)
            if target is None:
                continue
            blocks = candidate_blocks(self.registry[a.function].tag,
                                      self.script)
            if not any(valid(a.function, target, conf, self.registry, b)
                       for b in blocks):
                raise AssertionError(f"the planner placed {a.function} on "
                                     f"{target}, where Listing 1 refuses it")
        self.actions.extend(actions)
        return actions


def predictive_run(replicas: int, trace, policy: str = "predictive",
                   **platform_kw) -> dict:
    """``trace`` through a fresh simulator over ``replicas`` testbed copies
    behind ``benchmarks/coldstart.py``'s pool under ``policy``, decided one
    arrival at a time by the port's Platform; with ``predictive``, the
    arrival forecast (seeded from the script's affinity terms, bound to the
    policy, fed by the workload driver) and the checked planner on the
    simulator's epochs, until half an interval after the PRED_EPOCHS-th
    epoch.  Returns what the checks and the numbers read."""
    keep = make_policy(policy, ttl=TRACE_TTL)
    pool = WarmPool(keep, costs=StartCosts(**TRACE_COSTS),
                    budget_mb=TRACE_BUDGET_MB, hot_window=1.0)
    sim = ClusterSim(scaled_testbed(replicas), SimParams(), seed=TRACE_SEED,
                     pool=pool, plan_interval=PLAN_INTERVAL,
                     migrate_cost=MIGRATE_COST)
    register_functions(sim.registry)
    plat = Platform.for_sim(sim, PRED_SCRIPT, **platform_kw)
    forecast = planner = None
    if policy == "predictive":
        forecast = ArrivalForecast(tau=PRED_TAU)
        forecast.seed_affinity(plat.script, sim.registry)
        keep.bind(forecast)
        planner = sim.planner = CheckedPlanner(forecast, plat.compiled,
                                               sim.registry, PlanConfig())
    rng = random.Random(TRACE_SEED + 1)
    wl = TraceWorkload(sim, plat.placer(rng), COMPUTE_S, script=plat.script,
                       forecast=forecast)
    wl.load(trace)
    sim.at((PRED_EPOCHS + 0.5) * PLAN_INTERVAL, _stop)
    t0 = time.perf_counter()
    try:
        sim.run()
    except Horizon:
        pass
    wall = time.perf_counter() - t0
    return {"records": list(wl.records),
            "rng_tail": tuple(rng.random() for _ in range(4)),
            "pool": pool.metrics.snapshot(),
            "planner": None if planner is None else dict(planner.stats),
            "planner_epoch_s": None if planner is None else planner.epoch_s,
            "actions": None if planner is None else planner.actions,
            "wall_s": wall, "events": sim.stats["events"], "end_s": sim.now,
            "decisions": plat.session.stats["decisions"]}


def host_processes(n: int):
    """``n`` spawned processes for the twins (``device="cpu"``, the float64
    ``backend="np"``), which need no card and so run beside the card's
    run; each imports this script afresh, its torch on one intra-op
    thread.  Leaving the ``with`` block stops them."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    return ProcessPoolExecutor(
        n, mp_context=multiprocessing.get_context("spawn"),
        initializer=torch.set_num_threads, initargs=(1,))


def predictive_path(replicas: int = TRACE_REPLICAS, device="cuda") -> dict:
    """Phase 13: the predictive trace on ``device`` with the launch counters
    reset just before it and read just after, held to its twins
    (``device="cpu"``: the kernels' plain versions; the float64
    ``backend="np"``; both in processes of their own, beside it): records,
    rng tail, the pool's metrics and the planner's stats equal; at least
    one prewarm; every prewarm and migration target Listing-1 valid
    (:class:`CheckedPlanner`); one ``affinity_valid`` launch a decision on
    the card.  Beside it the same trace under the ``affinity`` policy
    (``device="cpu"``, in a third process: it decides the same), for the
    cold-start rate.  Returns the numbers printed."""
    trace = build_trace(PRED_SCENARIO, duration=PRED_WINDOW,
                        rate=PRED_RATE * replicas, seed=TRACE_SEED)
    on_card = torch.device(device).type == "cuda"
    with host_processes(3) as pool:
        twins = {"cpu": pool.submit(predictive_run, replicas, trace,
                                    device="cpu"),
                 "np": pool.submit(predictive_run, replicas, trace,
                                   backend="np")}
        aff = pool.submit(predictive_run, replicas, trace,
                          policy="affinity", device="cpu")
        for k in KERNELS:
            k.launches = 0
        run = predictive_run(replicas, trace, device=device)
        launches = {k.name: k.launches for k in KERNELS}
        twins = {name: f.result() for name, f in twins.items()}
        aff = aff.result()
    for name, twin in twins.items():
        for key in ("rng_tail", "pool", "planner"):
            if run[key] != twin[key]:
                raise AssertionError(f"the predictive trace's {key} differs "
                                     f"from the {name} twin's: {run[key]} "
                                     f"against {twin[key]}")
        if not records_equal(run["records"], twin["records"]):
            raise AssertionError("the predictive trace's records differ "
                                 f"from the {name} twin's")
    if not run["planner"]["prewarms"] > 0:
        raise AssertionError(f"no planning epoch issued a prewarm: "
                             f"{run['planner']}")
    if on_card and launches != {"affinity_valid": run["decisions"],
                                "bulk_decide": 0}:
        raise AssertionError(f"the predictive trace launched {launches} for "
                             f"{run['decisions']} decisions")
    epoch_ms = [t * 1e3 for t in run["planner_epoch_s"]]
    return {"workers": 6 * replicas, "window_s": PRED_WINDOW,
            "rate_per_s": PRED_RATE * replicas, "arrivals": len(trace),
            "records": len(run["records"]), "decisions": run["decisions"],
            "launches": launches, "wall_s": run["wall_s"],
            "events": run["events"],
            "us_per_decision": run["wall_s"] / run["decisions"] * 1e6,
            "np_twin_us_per_decision":
                twins["np"]["wall_s"] / twins["np"]["decisions"] * 1e6,
            "cpu_twin_wall_s": twins["cpu"]["wall_s"],
            "planner": run["planner"],
            "planner_ms_per_epoch_median": statistics.median(epoch_ms),
            "planner_ms_per_epoch": epoch_ms,
            "pool": run["pool"],
            "cold_start_rate": run["pool"]["cold_start_rate"],
            "affinity_cold_start_rate": aff["pool"]["cold_start_rate"],
            "affinity_cpu_wall_s": aff["wall_s"],
            "end_s": run["end_s"],
            "reduced": {"window_s": PRED_WINDOW, "epochs": PRED_EPOCHS,
                        "why": "a window of roots at the full rate and "
                               "cluster, the run stopped after its "
                               f"planning epoch {PRED_EPOCHS}"}}


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
    ap.add_argument("--baseline-flash", type=Path, default=None,
                    help="an earlier flash_attention_sm90.cu (same C entry "
                    "point) to build and time beside this one at the bf16 "
                    "shapes of phases 8, 15 and 16")
    args = ap.parse_args(argv)
    wall = {"start": time.perf_counter()}

    def lap(phase: str):
        """Ends ``phase``, which began at the last lap."""
        wall[phase] = time.perf_counter()

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
    # cuBLAS's fixed workspace, read at its first call: phase 17 runs under
    # torch.use_deterministic_algorithms(True), which requires it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    # float32 products in full float32 (the defaults, stated): the float32
    # checks below compare paths, not TF32 roundings
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    lap("1")
    # 2. build, from the sources in this checkout (and the earlier flash
    # kernel, when asked, beside them)
    flash_base = None
    if args.baseline_flash is not None:
        k = fa.FLASH_ATTENTION_BF16_KERNEL
        flash_base = type(k)("flash_attention_bf16_baseline",
                             str(args.baseline_flash.resolve()),
                             entry=k.entry, argtypes=k.argtypes,
                             flags=k.flags)
    builds = (*ALL_KERNELS, *([flash_base] if flash_base else []))
    for k in builds:
        k.library_path().unlink(missing_ok=True)
    build_s = build_all(builds)
    ptxas = {k.name: ptxas_summary(k.build_log) for k in ALL_KERNELS}
    spilled = [name for name, p in ptxas.items() if p["spill_bytes"]]
    if spilled:
        raise AssertionError(f"kernels spill registers: {ptxas}")
    print(f"build: {', '.join(k.name for k in builds)} built in "
          f"{build_s:.2f} s (nvcc, sm_90a, in parallel); -Xptxas -v "
          f"registers per instance and spilled bytes: {ptxas}", flush=True)
    if flash_base is not None:
        print(f"baseline: {flash_base.source}: "
              f"{ptxas_summary(flash_base.build_log)}", flush=True)
    tiles = {hd: fa.kernel.compiled_tiles(hd) for hd in fa.kernel.HEAD_DIMS}
    print(f"flash_attention_bf16 tiles (rows, keys, stages, consumers) by "
          f"head dim: compiled {tiles}, kernel.TILES {fa.kernel.TILES}",
          flush=True)
    if tiles != fa.kernel.TILES:
        raise AssertionError("the bf16 flash kernel compiled other tiles "
                             "than kernel.TILES")

    lap("2")
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

    lap("3")
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

    lap("4")
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

    # 18(a), started here: the dry runs use the host's CPU alone, so they
    # run beside phases 6-16 (after phase 5's host timings)
    dry_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    atexit.register(shutil.rmtree, dry_dir, ignore_errors=True)
    dry_started = time.perf_counter()
    dry_procs = start_dryruns(dry_dir)

    lap("5")
    # 6. the serving path: gemma3-4b whole behind serve.Engine
    cfg = GEMMA3_4B
    serve_launches, main_err, main_f32, serving = serving_path(cfg)

    lap("6")
    # 7. one period of the model at full width in float32: flash vs direct
    f32_err, f32_scale, f32_launches = whole_model_f32(cfg)
    print(f"whole model, float32: gemma3-4b with n_layers=6 (one 5:1 "
          f"local:global period, full width), S = 2048; prefill logits via "
          f"flash vs direct: max abs err {f32_err} (bound {MODEL_F32_TOL}; "
          f"largest |logit| {f32_scale}); {f32_launches} flash launches",
          flush=True)

    lap("7")
    # 8. serving times
    flash_t = {(dtype, name): time_flash(
        dtype, window, seed=seed,
        baseline=flash_base if dtype == torch.bfloat16 else None)
               for dtype in (torch.bfloat16, torch.float32)
               for name, window, seed in (("causal", None, 11),
                                          ("window1024", cfg.sliding_window,
                                           12))}
    for (dtype, name), t in flash_t.items():
        kern = fa.choose_kernel(dtype, t["shape"][-1]).name
        print(f"time {tag}: {kern} {name} at {tuple(t['shape'])} "
              f"{t['dtype']}: {json.dumps(t)}", flush=True)
    print(f"serving end to end {tag}: {json.dumps(serving)}", flush=True)

    lap("8")
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

    lap("9")
    # 10. the SSM model at full width in float32: kernel vs plain scan
    s32 = model_f32(ssm_cfg, SSM_F32_LAYERS, seed=1)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"whole model, float32: {s32['model']} with n_layers="
          f"{s32['layers']} (full width), S = {F32_PROMPT}; logits at every "
          f"position via the scan kernel vs its plain version: "
          f"{json.dumps(s32)}", flush=True)

    lap("10")
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

    lap("11")
    # 12. the trace-driven decision path at 16,386 workers
    trace = trace_path()
    for run in ("A", "B"):
        print(f"trace path {tag}: run {run}: {json.dumps(trace[run])}",
              flush=True)

    lap("12")
    # 13. the forecast plug-in on the decision path at 16,386 workers
    pred = predictive_path()
    print(f"predictive trace {tag}: {json.dumps(pred)}", flush=True)

    lap("13")
    # 14. the MoE serving path: qwen3-moe-30b-a3b whole behind serve.Engine
    gc.collect()
    torch.cuda.empty_cache()
    print(f"device memory before qwen3-moe-30b-a3b: "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated",
          flush=True)
    moe_launches, moe_err, moe_f32, moe_serving = serving_path(QWEN3_MOE_30B)
    print(f"MoE serving end to end {tag}: {json.dumps(moe_serving)}",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    lap("14")
    # 15. jamba-1.5-large-398b (2 layers) and arctic-480b (1 layer) at full
    # width; jamba's float32 logits through the kernels vs plain; then the
    # kernels at the new shapes
    hybrid = {}
    for base in (JAMBA_15_LARGE, ARCTIC_480B):
        hybrid[base.name] = hybrid_path(base)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"full width {tag}: {json.dumps(hybrid[base.name])}",
              flush=True)
    h32 = model_f32(JAMBA_15_LARGE, HYBRID_DEPTHS[JAMBA_15_LARGE.name],
                    seed=2)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"whole model, float32: {h32['model']} with n_layers="
          f"{h32['layers']} (full width), S = {F32_PROMPT}; logits at every "
          f"position via the float32 flash and scan kernels vs their plain "
          f"versions: {json.dumps(h32)}", flush=True)
    shape_t = {}
    for cfg_, seed in ((QWEN3_MOE_30B, 16), (JAMBA_15_LARGE, 17),
                       (ARCTIC_480B, 18)):
        shape = (1, PROMPT, cfg_.n_heads, cfg_.n_kv_heads,
                 cfg_.resolved_head_dim)
        shape_t[cfg_.name] = time_flash(torch.bfloat16, None, seed=seed,
                                        shape=shape, baseline=flash_base)
        print(f"time {tag}: flash_attention_bf16 causal at {shape} "
              f"({cfg_.name}): {json.dumps(shape_t[cfg_.name])}", flush=True)
    scan_wide = time_scan(seed=19, D=2 * JAMBA_15_LARGE.d_model)
    print(f"time {tag}: selective_scan at {tuple(scan_wide['shape'])} "
          f"(jamba-1.5-large-398b): {json.dumps(scan_wide)}", flush=True)

    lap("15")
    # 16. the enc-dec and vlm serving paths: seamless-m4t-large-v2 whole,
    # internvl2-76b at full width with 4 layers
    gc.collect()
    torch.cuda.empty_cache()
    ev = encdec_vlm_path(flash_base)
    for name in ("seamless", "internvl2"):
        print(f"{name} serving end to end {tag}: "
              f"{json.dumps(ev[name]['serving'])}", flush=True)
    for name, t in ev["flash_times"].items():
        print(f"time {tag}: flash_attention_bf16 {name} at "
              f"{tuple(t['shape'])} (seamless-m4t-large-v2): "
              f"{json.dumps(t)}", flush=True)
    print(f"whole model, float32: seamless-m4t-large-v2 with "
          f"{ENCDEC_F32_LAYERS} + {ENCDEC_F32_LAYERS} layers (full width), "
          f"S = {F32_PROMPT} frames and tokens; logits at every target "
          f"position via the float32 flash kernel vs its plain version: "
          f"{json.dumps(ev['seamless_f32'])}", flush=True)

    lap("16")
    # the dry runs' records, before phase 17's peak of ~71 GB (each dry
    # run holds a context on the card)
    dry = collect_dryruns(dry_procs, dry_dir, dry_started)
    dry_wall_s = time.perf_counter() - dry_started

    lap("18(a) collected")
    # 17. training: gemma3-4b whole, a 6-layer crash-restart, float32 card
    # vs cpu
    train = train_path()
    for name, t in train.items():
        print(f"training {tag}: {name}: {json.dumps(t)}", flush=True)
    print(peak_line(train["whole"], tag), flush=True)

    lap("17")
    # 18. the mesh and roofline tooling: (a) the dry runs at full size, (b)
    # the oracle's bound held against the card, (c) a (1, 1) DTensor mesh
    t18 = time.perf_counter()
    for cell, rec in dry.items():
        r, m = rec["roofline"], rec["memory"]
        print(f"dry run: {cell} on {rec['n_chips']} fake ranks (--device "
              f"cuda), traced in {rec['trace_s']} s: compute "
              f"{r['compute_s'] * 1e3:.3f} ms, memory "
              f"{r['memory_s'] * 1e3:.3f} ms, collective "
              f"{r['collective_s'] * 1e3:.3f} ms, dominant {r['dominant']}; "
              f"a device holds {m['argument_bytes'] / 1e9:.3f} GB of "
              f"arguments, peak {m['peak_bytes'] / 1e9:.3f} GB, temp "
              f"{m['temp_bytes'] / 1e9:.3f} GB, output "
              f"{m['output_bytes'] / 1e9:.6f} GB; {json.dumps(rec)}",
              flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    oracle = {}
    for base, seed, kw in ((GEMMA3_4B, 31, {}),
                           (FALCON_MAMBA_7B, 32, {"scan_impl": "chunked"})):
        oracle[base.name] = oracle_vs_card(base, seed, **kw)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"oracle vs card {tag}: {json.dumps(oracle[base.name])}",
              flush=True)
    tb = train_step_counted_bound(train["whole"])
    print(f"oracle, phase 17's train step: counted bound "
          f"{tb['counted_bound_ms']:.3f} ms against the hand-worked "
          f"{tb['hand_worked_bound_ms']} ms (PERF.md §5); measured "
          f"{train['whole']['step_ms_median_after_first']:.1f} ms {tag}: "
          f"{json.dumps(tb)}", flush=True)
    dtp = dtensor_prefill(GEMMA3_4B)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"DTensor prefill: {json.dumps(dtp)}", flush=True)
    print(f"phase 18: {time.perf_counter() - t18:.1f} s here; the dry runs "
          f"(traced in {[rec['trace_s'] for rec in dry.values()]} s) ran "
          f"beside phases 6-16 and were collected {dry_wall_s:.1f} s after "
          "they started", flush=True)

    lap("18")
    # 19. training of the ssm and hybrid families
    t19 = time.perf_counter()
    ssm_train = ssm_train_path()
    for name, t in ssm_train.items():
        print(f"ssm training {tag}: {name}: {json.dumps(t)}", flush=True)
    print(peak_line(ssm_train["whole"], tag), flush=True)
    print(f"phase 19: {time.perf_counter() - t19:.1f} s", flush=True)
    lap("19")
    names = list(wall)
    print(f"seconds a phase {tag}: " + json.dumps(
        {b: round(wall[b] - wall[a], 1) for a, b in zip(names, names[1:])})
        + f"; {wall['19'] - wall['start']:.1f} s from phase 1 to 19",
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
                         for run in ("A", "B")},
                     "predictive_path_launches": pred["launches"][name],
                     "moe_serving_launches": moe_launches[name]})
    # the bf16 kernel's launches are the serving run's; the float32
    # kernel's are phase 7's (the float32 period: no bf16 path runs it)
    hybrid_flash_err = [f["max_abs_err"] for h in hybrid.values()
                        for f in h["flash_vs_plain"].values()]
    ev_bf16_err = [e for name in ("seamless", "internvl2")
                   for e in ev[name]["flash_bf16_err"].values()]
    ev_f32_err = [e for name in ("seamless", "internvl2")
                  for e in ev[name]["flash_f32_err"].values()]
    for k, dtype, n, err in (
            (fa.FLASH_ATTENTION_BF16_KERNEL, torch.bfloat16,
             serve_launches["flash_attention_bf16"],
             max(flash_err[torch.bfloat16], *main_err.values(),
                 *moe_err.values(), *hybrid_flash_err, *ev_bf16_err)),
            (fa.FLASH_ATTENTION_KERNEL, torch.float32, f32_launches,
             max(flash_err[torch.float32], *main_f32.values(),
                 *moe_f32.values(), *ev_f32_err))):
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
                                     "bound_ms", "bound_by")},
                     "moe_serving_launches": moe_launches[k.name],
                     "full_width_launches": {
                         name: h["launches"][k.name]
                         for name, h in hybrid.items()},
                     "float32_full_width_launches": h32["launches"][k.name],
                     "encdec_serving_launches":
                         ev["seamless"]["launches"][k.name],
                     "vlm_serving_launches":
                         ev["internvl2"]["launches"][k.name],
                     "encdec_float32_launches":
                         ev["seamless_f32"]["launches"][k.name],
                     "training_launches":
                         train["whole"]["launches"][k.name],
                     "shapes": {name: {
                         key: t_[key] for key in (
                             "shape", "ms", "device_ms", "plain_ms",
                             "library_ms", "library_device_ms", "bound_ms",
                             "bound_by", "mufu_floor_ms")}
                         for name, t_ in (*shape_t.items(), *(
                             (f"seamless-m4t-large-v2 {n}", t_)
                             for n, t_ in ev["flash_times"].items()))}
                     if dtype == torch.bfloat16 else None})
    k = ms.SELECTIVE_SCAN_KERNEL
    rows.append({"name": k.name, "route": "cuda",
                 "source": str(k.source.relative_to(ROOT)),
                 "replaces": REPLACES[k.name],
                 "launches": ssm_launches[k.name],
                 "max_abs_err": max(scan_err, scan_live_err, *(
                     h["scan_vs_plain"]["max_abs_err"]
                     for h in hybrid.values() if h["scan_vs_plain"])),
                 "ms": scan_t["ms"], "plain_ms": scan_t["plain_ms"],
                 "bound_ms": scan_t["bound_ms"],
                 "bound_by": scan_t["bound_by"], "library_ms": None,
                 "device_ms": scan_t["device_ms"],
                 "shape": scan_t["shape"],
                 "full_width_launches": {
                     name: h["launches"][k.name]
                     for name, h in hybrid.items()},
                 "float32_full_width_launches": h32["launches"][k.name],
                 "ssm_training_launches": ssm_train["launches"][k.name],
                 "d16384": {key: scan_wide[key] for key in (
                     "shape", "ms", "device_ms", "plain_ms", "bound_ms",
                     "bound_by")}})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
