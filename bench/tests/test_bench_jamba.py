"""The jamba2-mini-16l configuration's pieces under ``bench/``: its leaves
load strictly into the port (at the published widths on ``meta``, and
drawn at small widths), its FLOP and byte counts against hand counts at
the published sizes, its readers, its cell's entries and limits, and small
runs of the harness on the CPU: ``correct`` holds, the fp8 control fails,
and each planted fault (``bench/tests/small_jamba.py``) fails."""
import math
import os
import time
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", 1))))

from bench.entries import prefill  # noqa: E402
from bench.harness import flops, peaks, results, spec  # noqa: E402
from bench.harness.trace import Summary  # noqa: E402
from bench.harness.weights import Weights, _torch_dtype  # noqa: E402
from bench.reference import jamba  # noqa: E402
from bench.tests import small, small_jamba  # noqa: E402
from repro_torch.obs import spans  # noqa: E402

CPU = torch.device("cpu")
D, H, K, hd, E, k, F, V, L = 4096, 32, 8, 128, 16, 2, 14336, 65536, 16
di, N, R = 8192, 16, 256


def test_the_leaves_are_the_ports_parameters_at_the_published_widths():
    from repro_torch.models import params_shape

    cfg = spec.config(small_jamba.NAME)
    got = {leaf.name: (tuple(leaf.shape), _torch_dtype(torch, leaf.dtype))
           for leaf in jamba.leaves(cfg)}
    want = {n: (tuple(p.shape), p.dtype) for n, p in
            params_shape(prefill.port_config(cfg)).named_parameters()}
    assert got == want
    size = sum(leaf.numel * _torch_dtype(torch, leaf.dtype).itemsize
               for leaf in jamba.leaves(cfg))
    assert size == pytest.approx(52.1e9, rel=2e-3)  # the stage: 52.1 GB


def test_the_leaves_load_strictly_at_small_widths():
    cfg = small_jamba.config()
    w = Weights(jamba.leaves(cfg), seed=2, device=CPU)
    model = prefill.load_model(prefill.port_config(cfg), w)
    state = w.state_dict()
    assert all(torch.equal(p, state[n]) for n, p in model.named_parameters())
    assert not torch.equal(state["layers.0.ssm.b_norm"],
                           torch.ones_like(state["layers.0.ssm.b_norm"]))


def test_matmul_params_and_flops_by_hand():
    cfg = spec.config(small_jamba.NAME)
    mamba = D * 2 * di + di * (R + 2 * N) + R * di + di * D
    assert mamba == 67_108_864 + 2_359_296 + 2_097_152 + 33_554_432
    attn = D * H * hd + 2 * D * K * hd + H * hd * D
    assert attn == 41_943_040
    dense, moe = 3 * D * F, D * E + k * 3 * D * F
    # 14 Mamba and 2 attention layers, 8 dense and 8 MoE FFNs
    assert jamba.matmul_params(cfg) == 14 * mamba + 2 * attn + 8 * dense \
        + 8 * moe == 5_783_945_216
    # the experts do 49% of the matrix work
    assert 8 * k * 3 * D * F / jamba.matmul_params(cfg) == pytest.approx(
        0.4873, abs=1e-4)
    assert jamba.attention_shape(cfg) == (2, 32, 128)
    assert jamba.moe_layers(cfg) == 8
    S = 1000
    causal = 4 * H * hd * S * (S + 1) // 2  # q k^T and p v, kept pairs
    want = 2 * 5_783_945_216 * S + 2 * D * V + 2 * causal
    assert flops.prefill_flops(jamba, cfg, S) == want


def test_scan_calls_and_bytes_as_falcons():
    """14 scan calls a prefill, each counted as falcon-mamba-7b's at the
    same widths (d_inner 8,192, state 16)."""
    cfg = spec.config(small_jamba.NAME)
    falcon = spec.config("falcon-mamba-7b")
    mamba = spec.reference("mamba")
    assert jamba.scan_layers(cfg) == 14
    for S in (1, 1000, 8192):
        assert jamba.scan_bytes(cfg, S) == mamba.scan_bytes(falcon, S) == \
            S * di * 10 + 2 * S * N * 2 + di * N * 4


def test_expert_flops_and_bytes_by_hand():
    cfg = spec.config(small_jamba.NAME)
    assert jamba.expert_flops(cfg, 1000) == 2 * 1000 * 2 * 3 * D * F \
        == 704_643_072_000
    # every expert reached; each expert's three bf16 matrices, 352.3 MB
    assert jamba.expert_bytes(cfg, 1000) == pytest.approx(
        2 * (16 * 3 * D * F + 2 * 1000 * 2 * D), rel=1e-12)
    assert jamba.expert_bytes(cfg, 1000) == pytest.approx(5_669_912_576)
    # a single token reaches its 2 experts only
    assert jamba.expert_bytes(cfg, 1) == pytest.approx(
        2 * (2 * 3 * D * F + 2 * 2 * D))
    # an MoE layer's expert weights (1.68 ms at 3.35 TB/s) and its products
    # (0.71 us a token at the bf16 peak) meet near 2,400 tokens; the whole
    # model's weights and FLOPs (52.1 GB, 11.6 GFLOP a token) near 1,330
    meet = [S for S in range(200, 3000) if jamba.expert_flops(cfg, S)
            / peaks.BF16_FLOPS >= jamba.expert_bytes(cfg, S) / peaks.HBM_BYTES]
    assert 2350 <= meet[0] <= 2450
    per_token = flops.prefill_flops(jamba, cfg, 2) - flops.prefill_flops(
        jamba, cfg, 1)
    assert 52.1e9 / peaks.HBM_BYTES / (per_token / peaks.BF16_FLOPS) == \
        pytest.approx(1330, rel=0.01)


def _trace(kernels, requests):
    ops = [(n, 0.0, t) for n, t in kernels]
    return Summary(ops=ops, window_s=1.0, busy_s=0.5, gaps=[],
                   requests=requests)


def test_expert_roofline_reads_the_grouped_kernels_only():
    cfg = spec.config(small_jamba.NAME)
    reader = spec.metric_reader("expert_roofline")
    grouped = reader.GROUPED[0]
    recs = [SimpleNamespace(index=i, length=n, profiled=True)
            for i, n in enumerate([200, 4000])]
    ctx = SimpleNamespace(trace=_trace([(f"k_{grouped}_a", 0.030),
                                        ("nvjet_gemm", 5.0),
                                        (f"k_{grouped}_b", 0.010)], [0, 1]),
                          family=jamba, config=cfg, records=recs)
    bound = 8 * (jamba.expert_bytes(cfg, 200) / peaks.HBM_BYTES
                 + jamba.expert_flops(cfg, 4000) / peaks.BF16_FLOPS)
    assert reader.read(ctx) == pytest.approx(100 * bound / 0.040)
    ctx.trace = _trace([("nvjet_gemm", 1.0)], [0, 1])
    assert reader.read(ctx) is None
    ctx.family = spec.reference("mamba")
    assert reader.read(ctx) is None


#: the per-layer entries that read the cell: the shared readers of the
#: model step, the SSM block and the device, and the MoE FFN's and
#: attention's own.  Not ``ttft_p90_ms``, whose spread over seeds there sits
#: at nine tenths of half its bound, nor the engine's readers, which move it
READERS = {"mfu.prefill", "pointwise_ms_per_ktok", "short_layer_us",
           "scan_roofline", "idle_share.prefill", "expert_roofline",
           "moe_layer_us", "flash_roofline"}


def test_the_benchmark_lists_the_cell_on_its_readers():
    bench = spec.benchmark()
    cell = spec.cell(bench, small_jamba.CELL["name"])
    assert cell == {**small_jamba.CELL, "why": cell["why"]}
    traced = {m["name"] for m in spec.metrics_for(bench, cell["name"], True)}
    assert traced == READERS
    e2e = {m["name"] for m in spec.metrics_for(bench, cell["name"], False)}
    assert e2e == {"prefill_tokens_per_s", "setup_s"}


def test_the_cells_limit_sits_between_its_readings():
    """The program's largest ``logit_err`` and the fp8 control's smallest
    on the card, each at least 1.5x from the limit."""
    lim = spec.limits(small_jamba.CELL["name"])
    got = lim["readings"]["logit_err"]
    assert lim["logit_err"] >= 1.5 * got["lower"]
    assert lim["logit_err"] <= got["upper"] / 1.5
    assert lim["misplaced"] == lim["unserved"] == 0


def _run(seed=2**31 + 99, trace=False, control=False):
    return results.run_cell(spec.benchmark(), small_jamba.CELL, seed=seed,
                            seconds=0.3, trace=trace, device=CPU,
                            t_start=time.perf_counter(),
                            config=small_jamba.config(), mix=small.mix(),
                            limits=small.LIMITS, control=control)


def test_a_small_run_is_correct_and_its_control_fails():
    out = _run(control=True)
    checks = out["checks"]
    assert out["correct"] and out["failed"] == 0, checks
    assert checks["logit_err"]["control"] > small.LIMITS["logit_err"]
    assert checks["logit_err"]["control"] > 3 * checks["logit_err"]["value"]


def test_a_small_traced_run_reads_the_cells_host_metrics():
    spans.clear()
    out = _run(seed=2**31 + 5, trace=True)
    assert out["correct"], out["checks"]
    m = out["metrics"]
    assert math.isfinite(m["moe_layer_us"]["value"])
    assert m["moe_layer_us"]["value"] > 0
    assert m["mfu.prefill"]["value"] > 0
    # no device on the CPU: the device readers read nothing
    assert not {"expert_roofline", "flash_roofline",
                "idle_share.prefill"} & set(m)
    assert spans.dropped() == 0
    spans.clear()


@pytest.mark.parametrize("fault", sorted(small_jamba.FAULTS))
def test_a_planted_fault_is_caught(fault, monkeypatch):
    small_jamba.plant(fault, monkeypatch)
    out = _run()
    assert not out["correct"]
    assert out["checks"]["logit_err"]["value"] > small.LIMITS["logit_err"]
