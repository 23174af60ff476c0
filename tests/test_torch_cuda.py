"""The port on the card: each affinity kernel against its plain PyTorch
version on the same card inputs (bit for bit, no tolerance), the main path
through the kernels against the same path through the plain versions on
the CPU, the flash-attention kernels against their plain version (float32
within ``tests/test_kernels.py``'s 2e-5, bf16 within the bound of the
kernel's roundings, ``chip_smoke.FLASH_TOL``), and the selective-scan
kernel against its plain version within that file's 1e-4, short traces
through ``TraceWorkload`` on ``ClusterSim`` (the trace path and the
predictive trace) against the same traces on the plain versions, and a
MoE layer on the card against the CPU.  Every test here needs an NVIDIA GPU and skips without
one; the module imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch built for CUDA."""
import os

import pytest

torch = pytest.importorskip("torch")
# torch's intra-op threads: this pytest-xdist worker's share of the cores
torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", 1))))

import chip_smoke  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.kernels.affinity import (KERNELS, affinity_valid,  # noqa: E402
                                          bulk_decide, bulk_kernel)
from repro_torch.kernels.affinity.bulk_ref import bulk_decide_ref  # noqa: E402
from repro_torch.kernels.affinity.ref import affinity_valid_ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")


def _assert_bulk_equal(got, want):
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    assert torch.equal(got[2], want[2])


def _keys_are_reset():
    """Every per-stream key buffer as a launch must leave it: ticket 0,
    every key all ones."""
    for buf in bulk_kernel.ROW_KEYS.buffers.values():
        assert int(buf[0]) == 0 and bool((buf[1:] == -1).all())


@pytest.mark.parametrize("W,T,R", [*chip_smoke.AFFINITY_CASES, (257, 33, 9)])
def test_kernels_equal_plain_versions_on_the_card(card, W, T, R):
    ins, (strat, warm) = chip_smoke.on_card(
        chip_smoke.kernel_case(W, T, R, seed=W + T + R))
    before = [k.launches for k in KERNELS]
    assert torch.equal(affinity_valid(*ins), affinity_valid_ref(*ins))
    got = bulk_decide(*ins, strat, warm)
    _assert_bulk_equal(got, bulk_decide_ref(*ins, strat, warm))
    assert int(got[2][0]) == 0  # the all-tied row: lowest index
    if R > 1:
        assert int(got[2][1]) == -1  # the row with no valid worker
    assert [k.launches for k in KERNELS] == [n + 1 for n in before]
    _keys_are_reset()


def test_winners_are_the_same_in_every_run_on_the_card(card):
    """20 calls of one wave at the 512-tag scale, with many tied scores
    (strategy best_first, warmth 0..2): the atomics' order never moves a
    winner."""
    case = chip_smoke.kernel_case(16384, 512, 512, seed=21)
    case[9][:] = 0
    ins, extra = chip_smoke.on_card(case)
    first = bulk_decide(*ins, *extra)
    _assert_bulk_equal(first, bulk_decide_ref(*ins, *extra))
    for _ in range(19):
        assert torch.equal(bulk_decide(*ins, *extra)[2], first[2])


def test_back_to_back_calls_and_two_streams_keep_their_keys_on_the_card(card):
    """Calls of different R back to back on one stream (the key buffer
    grows between them), then two waves at once on two streams: each equals
    its plain version, and every key buffer is left reset."""
    cases = [chip_smoke.on_card(chip_smoke.kernel_case(4099, 40, R,
                                                       seed=R))
             for R in (3, 1100, 5, 700)]
    want = [bulk_decide_ref(*ins, *extra) for ins, extra in cases]
    got = [bulk_decide(*ins, *extra) for ins, extra in cases]
    for g, w in zip(got, want):
        _assert_bulk_equal(g, w)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    for _ in range(5):
        got = [None, None]
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                got[i] = bulk_decide(*cases[i + 1][0], *cases[i + 1][1])
        torch.cuda.synchronize()
        for g, w in zip(got, want[1:3]):
            _assert_bulk_equal(g, w)
    _keys_are_reset()


@pytest.mark.parametrize("offset", [1, 3])
def test_kernels_take_misaligned_inputs_on_the_card(card, offset):
    """Contiguous inputs that start off a 16-byte boundary (slices of a
    larger buffer) take the kernels' scalar paths and give the same
    bits."""
    W, T, R = 1028, 64, 20
    ins, extra = chip_smoke.on_card(chip_smoke.kernel_case(W, T, R, seed=9))

    def shifted(t):
        buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
        view = buf[offset:].view(t.shape)
        view.copy_(t)
        return view

    ins = tuple(shifted(t) for t in ins)
    extra = tuple(shifted(t) for t in extra)
    assert torch.equal(affinity_valid(*ins), affinity_valid_ref(*ins))
    _assert_bulk_equal(bulk_decide(*ins, *extra),
                       bulk_decide_ref(*ins, *extra))


def test_main_path_on_the_card_equals_the_plain_versions(card):
    got, _ = chip_smoke.drive_main_path(chip_smoke.build_rig(4096))
    want, _ = chip_smoke.drive_main_path(
        chip_smoke.build_rig(4096, device="cpu"))
    assert got == want


def test_trace_path_on_the_card_equals_the_plain_versions(card):
    """A short run A (traced, resilience, zone outage) and run B (waves)
    of ``chip_smoke``'s trace path at 64 testbed copies (384 workers):
    every record, rng draw and decision log equal to the ``device="cpu"``
    run's and the float64 twin's (``trace_path`` raises otherwise), run A
    through ``affinity_valid``, run B one ``bulk_decide`` a wave."""
    out = chip_smoke.trace_path(64, min_arrivals=1024, ticks=4,
                                per_tick=128)
    assert out["A"]["launches"]["affinity_valid"] == out["A"]["decisions"]
    assert out["B"]["launches"] == {"affinity_valid": 0, "bulk_decide": 4}


def test_predictive_path_on_the_card_equals_the_plain_versions(card):
    """``chip_smoke``'s predictive trace at 48 testbed copies (288
    workers): records, rng draws, pool metrics and planner stats equal to
    the ``device="cpu"`` run's and the float64 twin's (``predictive_path``
    raises otherwise), prewarms issued on Listing-1 valid workers, one
    ``affinity_valid`` launch a decision."""
    out = chip_smoke.predictive_path(48)
    assert out["launches"]["affinity_valid"] == out["decisions"]
    assert out["planner"]["prewarms"] > 0


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
def test_moe_ffn_on_the_card_equals_the_cpu(card, mlp_type):
    """One float32 MoE layer on the card against the same layer on the
    CPU, within the 1e-5 the CPU tests hold it to against the reference,
    with groups that overflow their capacity."""
    from repro_torch.configs import MoESpec
    from repro_torch.models.moe import MoE, moe_ffn

    spec = MoESpec(n_experts=8, top_k=2, d_ff_expert=32, group_size=64,
                   capacity_factor=0.5)
    gen = torch.Generator().manual_seed(0)
    moe = MoE(64, spec, torch.float32, mlp_type, generator=gen, device="cpu")
    x = torch.randn((2, 100, 64), generator=gen)
    want = moe_ffn(moe, x, spec, mlp_type)
    got = moe_ffn(moe.cuda(), x.cuda(), spec, mlp_type)
    assert float((got.cpu() - want).abs().max()) < 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", chip_smoke.FLASH_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_flash_attention_equals_its_plain_version_on_the_card(card, case,
                                                              dtype):
    """Ragged lengths, Sq != Skv, GQA ratios 1, 2, 4, head dims 64, 128,
    256, window 1 and a window past the sequence; float32 through the
    float32 kernel within 2e-5, bf16 through the tensor-core kernel within
    the per-element bound of its roundings, on the whole inputs and on v
    restricted to a late key tile (a dropped key tile beyond 4x that bound
    in both); each launch counted on the dtype's kernel and on no other."""
    B, Sq, Skv, H, K, hd, causal, window = case
    q, k, v = chip_smoke.flash_inputs(B, Sq, Skv, H, K, hd, dtype, seed=Sq)
    before = {kern.name: kern.launches for kern in fa.KERNELS}
    err, checks = chip_smoke.compare_flash(q, k, v, causal, window)
    if dtype == torch.bfloat16:
        assert set(checks) == {"whole", "late"}
        for check in checks.values():
            assert check["err_over_tol"] <= 1
            assert check["drop_over_tol"] >= chip_smoke.FLASH_DROP
        moved, n = fa.FLASH_ATTENTION_BF16_KERNEL, 2
    else:
        assert err <= chip_smoke.FLASH_TOL[torch.float32] and checks is None
        moved, n = fa.FLASH_ATTENTION_KERNEL, 1
    assert {kern.name: kern.launches for kern in fa.KERNELS} == {
        **before, moved.name: before[moved.name] + n}


@pytest.mark.parametrize("hd", fa.kernel.HEAD_DIMS)
def test_bf16_flash_compiles_the_wrappers_tiles_on_the_card(card, hd):
    """``flash_attention_bf16_tiles`` of the built library (query rows,
    keys a tile, stages, consumers) is ``kernel.TILES``; a head dim with
    no instance is refused."""
    assert fa.kernel.compiled_tiles(hd) == fa.kernel.TILES[hd]
    with pytest.raises(ValueError, match="head_dim 96"):
        fa.kernel.compiled_tiles(96)


def test_flash_attention_refuses_an_unsupported_head_dim_on_the_card(card):
    q = torch.zeros((1, 8, 2, 96), device="cuda")
    with pytest.raises(ValueError, match="head_dim 96"):
        fa.flash_attention(q, q[:, :, :1], q[:, :, :1])


@pytest.mark.parametrize("case", chip_smoke.SCAN_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_selective_scan_equals_its_plain_version_on_the_card(card, case):
    """The sweep shapes of tests/test_kernels.py, a ragged S and D, N of 1
    and 32, bfloat16 inputs; each launch counted."""
    B, S, D, N, dtype = case
    ins = chip_smoke.scan_inputs(B, S, D, N, dtype, seed=S + D)
    before = ms.SELECTIVE_SCAN_KERNEL.launches
    err = chip_smoke.compare_scan(*ins)[0]
    assert err <= chip_smoke.SCAN_TOL
    assert ms.SELECTIVE_SCAN_KERNEL.launches == before + 1


def test_selective_scan_takes_mixed_types_on_the_card(card):
    """dt in float32 and x, b, c in bfloat16, as the mamba block passes
    them."""
    dt, x, b, c, a = chip_smoke.scan_inputs(1, 300, 256, 16, "float32",
                                            seed=3)
    x, b, c = (t.to(torch.bfloat16) for t in (x, b, c))
    assert chip_smoke.compare_scan(dt, x, b, c, a)[0] <= chip_smoke.SCAN_TOL


def test_selective_scan_refuses_an_unsupported_state_size_on_the_card(card):
    dt, x, b, c, a = chip_smoke.scan_inputs(1, 8, 32, 4, "float32", seed=0)
    with pytest.raises(ValueError, match="state size N = 3"):
        ms.selective_scan(dt, x, b[..., :3], c[..., :3], a[:, :3])


def test_selective_scan_carries_a_long_memory_on_the_card(card):
    """a = -0.01 exp(normal) over 32 chunks and more, the serving path's
    types: within SCAN_TOL of max(1, max |y|), where the plain version with
    the state reset at a chunk boundary misses by SCAN_CARRY x that."""
    before = ms.SELECTIVE_SCAN_KERNEL.launches
    err, tol, ratio = chip_smoke.scan_long_memory_check(seed=5)
    assert err <= tol
    assert ratio >= chip_smoke.SCAN_CARRY
    assert ms.SELECTIVE_SCAN_KERNEL.launches == before + 1


@pytest.mark.parametrize("N", [1, 2, 4],
                         ids=lambda n: f"K{ms.kernel.states_per_thread(n)}")
def test_selective_scan_each_states_per_thread_instance_on_the_card(card, N):
    """One case per K (states of a channel per thread): K = 1, 2, 4, at a
    ragged S and D over several chunks, float32 and the mixed types."""
    dt, x, b, c, a = chip_smoke.scan_inputs(2, 150, 72, N, "float32",
                                            seed=40 + N)
    assert chip_smoke.compare_scan(dt, x, b, c, a)[0] <= chip_smoke.SCAN_TOL
    x, b, c = (t.to(torch.bfloat16) for t in (x, b, c))
    assert chip_smoke.compare_scan(dt, x, b, c, a)[0] <= chip_smoke.SCAN_TOL
