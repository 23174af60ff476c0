"""The metrics' arithmetic: the tail covers every request and the rate the
whole-request span; the FLOP counts against hand counts of both
configurations (qwen3 at its published head_dim 128); the scan's and the
flash kernel's bounds against the figures the kernels were designed to."""
from types import SimpleNamespace

import pytest

from bench.harness import flops, peaks, spec


def _rec(i, t_submit, t_done, length=100, ok=True, latency=0.0):
    return SimpleNamespace(index=i, t_submit=t_submit, t_done=t_done,
                           wall=t_done - t_submit, length=length, ok=ok,
                           latency=latency, profiled=False)


def test_p90_is_the_nearest_rank_over_every_request():
    p90 = spec.metric_reader("ttft_p90_ms").nearest_rank
    walls = list(range(1, 101))  # 100 requests: p90 has 10 beyond it
    assert p90(walls, 0.9) == 90
    assert p90(walls[:11], 0.9) == 10
    assert p90([4.0], 0.9) == 4.0
    recs = [_rec(i, i, i + w / 1e3) for i, w in enumerate(walls)]
    recs[3].ok = False  # a failed request still counts with its time
    ctx = SimpleNamespace(window=recs)
    assert spec.metric_reader("ttft_p90_ms").read(ctx) == pytest.approx(90)


def test_rate_is_over_the_span_of_whole_requests():
    recs = [_rec(0, 10.0, 11.0, 300), _rec(1, 11.0, 12.5, 500),
            _rec(2, 12.5, 13.0, 200, ok=False)]
    ctx = SimpleNamespace(window=recs, span_s=13.0 - 10.0)
    # the failed request's tokens are not served, its time is in the span
    assert spec.metric_reader("prefill_tokens_per_s").read(ctx) == \
        pytest.approx(800 / 3.0)


def test_sched_us_is_the_submit_less_the_runner():
    recs = [_rec(0, 0.0, 0.010, latency=0.009),
            _rec(1, 1.0, 1.004, latency=0.001)]
    assert spec.metric_reader("sched_us").read(
        SimpleNamespace(window=recs)) == pytest.approx(2000.0)


def test_falcon_flops_by_hand():
    cfg = spec.config("falcon-mamba-7b")
    fam = spec.reference(cfg["reference"])
    D, di, N, R, V, L = 4096, 8192, 16, 256, 65024, 64
    per_layer = D * 2 * di + di * (R + 2 * N) + R * di + di * D
    assert per_layer == 67_108_864 + 2_359_296 + 2_097_152 + 33_554_432
    S = 4096
    want = 2 * L * per_layer * S + 2 * D * V  # no attention
    assert flops.prefill_flops(fam, cfg, S) == want
    # 2 x 6.73 B matrix parameters a token
    assert 2 * fam.matmul_params(cfg) == pytest.approx(13.456e9, rel=1e-3)


def test_qwen3_flops_by_hand_at_head_dim_128():
    cfg = spec.config("qwen3-moe-30b-a3b")
    assert cfg["head_dim"] == 128
    fam = spec.reference(cfg["reference"])
    D, H, K, hd, E, k, F, V, L = 2048, 32, 4, 128, 128, 8, 768, 151936, 48
    attn = D * H * hd + 2 * D * K * hd + H * hd * D  # q, k, v, o
    assert attn == 8_388_608 + 2 * 1_048_576 + 8_388_608
    per_layer = attn + D * E + k * 3 * D * F
    S = 1000
    causal = 4 * H * hd * S * (S + 1) // 2  # q k^T and p v, kept pairs
    want = 2 * L * per_layer * S + 2 * D * V + L * causal
    assert flops.prefill_flops(fam, cfg, S) == want
    # at the registry's derived head_dim 64 the count would be lower
    assert flops.prefill_flops(fam, {**cfg, "head_dim": 64}, S) < want


def test_scan_bound_matches_the_kernels_design_figure():
    cfg = spec.config("falcon-mamba-7b")
    fam = spec.reference(cfg["reference"])
    # (B, S, D, N) = (1, 4096, 8192, 16): 336.33 MB, 0.1004 ms
    assert fam.scan_bytes(cfg, 4096) == 336_330_752
    assert flops.scan_bound_s(fam, cfg, 4096) * 1e3 == pytest.approx(
        0.1004, abs=5e-5)


def test_flash_bound_matches_the_kernels_design_figure():
    # (B, S, H, K, hd) = (1, 4096, 64, 8, 128): 274.95 GFLOP, 0.278 ms
    assert flops.causal_attention_flops(4096, 64, 128) == pytest.approx(
        274.95e9, rel=1e-4)
    assert flops.flash_bound_s(4096, 64, 128) * 1e3 == pytest.approx(
        0.278, abs=5e-4)
    assert peaks.BF16_FLOPS == 989e12 and peaks.HBM_BYTES == 3.35e12


def test_every_metric_of_the_benchmark_has_a_reader():
    bench = spec.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]).read), m["name"]
