"""The port's affinity kernels against the JAX reference.

On the CPU the port's wrappers run the plain PyTorch versions; they must
equal the reference's float32 ``ref`` backend bit for bit on the whole
(valid, score, winner) triple — every comparison here is exact, no
tolerance — and the float64 numpy twin on (valid, winner) where memories lie
on the 0.25 grid.  The CUDA kernels themselves are held to the plain
versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import os
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# torch's intra-op threads: this pytest-xdist worker's share of the cores
torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", 1))))

from repro.kernels.affinity import affinity_valid_np as ref_affinity_valid_np  # noqa: E402
from repro.kernels.affinity import bulk_decide_np as ref_bulk_decide_np  # noqa: E402
from repro_torch.kernels.affinity import (  # noqa: E402
    NO_CAP,
    NO_CONC,
    affinity_valid,
    affinity_valid_np,
    bulk_decide,
    bulk_decide_np,
)
from repro_torch.kernels.affinity import bulk_kernel, kernel  # noqa: E402
from repro_torch.kernels.affinity.bulk_ref import bulk_decide_ref  # noqa: E402
from repro_torch.kernels.affinity.ops import as_inputs  # noqa: E402
from repro_torch.kernels.affinity.ref import affinity_valid_ref  # noqa: E402
from tests.test_bulk_kernels import SHAPES, _case  # noqa: E402

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as hyp_st  # noqa: E402

# the port's own tile edges: 128-worker blocks of 4 workers a thread, 512
# rows per block, 32 tags per mask word in chunks of 8 words — plus the
# reference's 128-wide Pallas tiles
PORT_SHAPES = SHAPES + [(257, 33, 9), (255, 32, 8), (513, 64, 17),
                        (131, 257, 513), (5, 31, 3)]
CSRC = Path(__file__).resolve().parents[1] / \
    "src/repro_torch/kernels/affinity/csrc"


def _assert_bits_equal(a, b):
    """Exact equality, float scores compared by their bit patterns."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == np.float32:
        a, b = a.view(np.uint32), b.view(np.uint32)
    np.testing.assert_array_equal(a, b)


def _check_against_ref(args):
    v_ref, s_ref, w_ref = ref_bulk_decide_np(*args, backend="ref")
    v, s, w = bulk_decide_np(*args, device="cpu")
    _assert_bits_equal(v, np.asarray(v_ref))
    _assert_bits_equal(s, np.asarray(s_ref))
    _assert_bits_equal(w, np.asarray(w_ref))
    valid = affinity_valid_np(*args[:9], device="cpu")
    _assert_bits_equal(valid, np.asarray(
        ref_affinity_valid_np(*args[:9], backend="ref")))
    _assert_bits_equal(valid, v)


@pytest.mark.parametrize("W,T,R", PORT_SHAPES)
def test_plain_versions_equal_reference_ref_bit_for_bit(W, T, R):
    _check_against_ref(_case(W, T, R, seed=W * 100003 + T * 101 + R))


@pytest.mark.parametrize("W,T,R", PORT_SHAPES)
def test_plain_versions_equal_numpy_twin_on_the_quarter_grid(W, T, R):
    """The float64 twin agrees on validity and winners (0.25-grid memories
    are exact in both widths)."""
    args = _case(W, T, R, seed=W * 7 + T * 13 + R)
    v_np, _s_np, w_np = ref_bulk_decide_np(*args, backend="np")
    v, _s, w = bulk_decide_np(*args, device="cpu")
    np.testing.assert_array_equal(v, v_np)
    np.testing.assert_array_equal(w, np.asarray(w_np))
    # the port's own np backend is the same twin
    v2, s2, w2 = bulk_decide_np(*args, backend="np")
    np.testing.assert_array_equal(v2, v_np)
    np.testing.assert_array_equal(np.asarray(w2), np.asarray(w_np))


def test_plain_versions_equal_pallas_interpret_mode():
    """(130, 5, 257) straddles every Pallas tile edge at once."""
    args = _case(130, 5, 257, seed=130 * 100003 + 5 * 101 + 257)
    v_pl, s_pl, w_pl = ref_bulk_decide_np(*args, backend="pallas")
    v, s, w = bulk_decide_np(*args, device="cpu")
    _assert_bits_equal(v, np.asarray(v_pl))
    _assert_bits_equal(s, np.asarray(s_pl))
    _assert_bits_equal(w, np.asarray(w_pl))


def test_all_tied_rows_pick_the_lowest_index_and_dead_rows_minus_one():
    W, T = 300, 3
    occ = np.zeros((W, T), np.int32)
    aff = np.zeros((4, T), np.int8)
    wmask = np.ones((4, W), bool)
    wmask[1, :17] = False  # tie among the rest: the first unmasked wins
    wmask[2] = False  # nothing valid: -1
    wmask[3, :] = False
    wmask[3, 299] = True  # the last worker alone
    mem = np.zeros(W, np.float32)
    maxm = np.full(W, 8.0, np.float32)
    nfn = np.zeros(W, np.int32)
    fmem = np.ones(4, np.float32)
    strat = np.array([0, 1, 2, 3], np.int32)
    args = (occ, aff, wmask, mem, maxm, nfn, fmem, None, None, strat, None)
    _v, _s, w = bulk_decide_np(*args, device="cpu")
    assert w.tolist() == [0, 17, -1, 299]
    _v, _s, w_ref = ref_bulk_decide_np(*args, backend="ref")
    assert np.asarray(w_ref).tolist() == w.tolist()


def test_empty_worker_axis_has_no_winner():
    args = _case(1, 2, 3, seed=0)
    args = (args[0][:0], args[1], args[2][:, :0], args[3][:0], args[4][:0],
            args[5][:0]) + args[6:10] + (args[10][:, :0],)
    v, s, w = bulk_decide_np(*args, device="cpu")
    assert v.shape == (3, 0) and s.shape == (3, 0)
    assert w.tolist() == [-1, -1, -1]


def test_constants_lock_step_with_the_reference():
    """The port restates bulk_ref's float32 constants (the reference module
    imports jax) and copies bulk_np/ref_np verbatim."""
    from repro.kernels.affinity import bulk_np as ref_bulk_np
    from repro.kernels.affinity import bulk_ref as ref_bulk_ref
    from repro.kernels.affinity import ref_np as ref_ref_np
    from repro_torch.kernels.affinity import bulk_np, bulk_ref, ref_np

    assert bulk_ref.WARMEST_BASE_F32 == ref_bulk_ref.WARMEST_BASE_F32 == 2**22
    assert bulk_ref.MIN_COST_LIFE_F32 == ref_bulk_ref.MIN_COST_LIFE_F32 \
        == (10, 2, 0)
    assert bulk_ref.MIN_COST_LOAD_CLAMP == ref_bulk_ref.MIN_COST_LOAD_CLAMP \
        == 2**24 - 16
    assert bulk_ref.F32_EXACT == ref_bulk_ref.F32_EXACT
    for name in ("STRATEGY_CODES", "LIFECYCLE_S", "CONGESTION_S",
                 "WARMEST_BASE", "STRAT_BEST_FIRST", "STRAT_LEAST_LOADED",
                 "STRAT_WARMEST", "STRAT_MIN_COST"):
        assert getattr(bulk_np, name) == getattr(ref_bulk_np, name), name
    assert (ref_np.NO_CAP, ref_np.NO_CONC) == (ref_ref_np.NO_CAP,
                                               ref_ref_np.NO_CONC)
    assert (NO_CAP, NO_CONC) == (ref_np.NO_CAP, ref_np.NO_CONC)


def test_tensor_wrappers_route_cpu_tensors_to_the_plain_versions():
    args = _case(37, 19, 23, seed=5)
    ins = as_inputs(*args[:9], torch.device("cpu"))
    assert torch.equal(affinity_valid(*ins), affinity_valid_ref(*ins))
    got = bulk_decide(*ins, args[9], args[10])
    want = bulk_decide_ref(*ins, torch.from_numpy(args[9]),
                           torch.from_numpy(args[10]))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@settings(max_examples=25, deadline=None)
@given(hyp_st.integers(0, 2**31 - 1), hyp_st.sampled_from([128, 256, 512]),
       hyp_st.integers(-1, 1), hyp_st.sampled_from([32, 128]),
       hyp_st.integers(-1, 1), hyp_st.sampled_from([8, 16]),
       hyp_st.integers(-1, 1))
def test_tile_edge_property(seed, w_edge, dW, t_edge, dT, r_edge, dR):
    """Shapes jittered around both machines' tile edges (Pallas 128-wide
    tiles; the CUDA kernels' 256-worker blocks, 8-row blocks and 32-tag
    words): the plain versions stay bit-identical to the reference."""
    _check_against_ref(_case(max(1, w_edge + dW), max(1, t_edge + dT),
                             max(1, r_edge + dR), seed))



def test_row_keys_are_one_reset_buffer_per_stream_grown_on_demand():
    """The bulk kernel's key buffer: ticket 0 then all-ones keys, at least
    1 + R words, the same tensor for the same (device, stream) until a
    call needs more rows, a separate one for another stream."""
    keys = bulk_kernel.RowKeys()
    cpu = torch.device("cpu")
    a = keys.get(6, cpu, 1)
    assert a.dtype == torch.int64 and a.numel() == 64
    assert int(a[0]) == 0 and bool((a[1:] == -1).all())
    assert keys.get(63, cpu, 1) is a
    b = keys.get(64, cpu, 1)
    assert b is not a and b.numel() == 128 and int(b[0]) == 0
    assert keys.get(3, cpu, 1) is b
    assert keys.get(3, cpu, 2) is not b
    assert keys.get(1100, cpu, 2).numel() >= 1101


def test_launch_geometry_mirrors_the_cuda_source():
    """kernel.BLOCK_ROWS (the wrapper's row limit) is the source's
    kBlockRows, and the source's rows per warp fit its 32-bit violation
    words."""
    src = (CSRC / "affinity_common.cuh").read_text()
    const = {m[0]: m[1] for m in re.findall(
        r"constexpr int (k\w+) = ([^;]+);", src)}
    assert const["kWarps"] == "16" and const["kRowsPerWarp"] == "32"
    assert kernel.BLOCK_ROWS == 16 * 32
    assert "kBlockRows = kWarps * kRowsPerWarp" in src
    assert kernel.MAX_ROWS == 65535 * kernel.BLOCK_ROWS


def test_card_cases_cover_the_kernels_edges():
    """chip_smoke.AFFINITY_CASES, which the card checks run, reach every
    edge of the kernels' geometry: W = 1, 3, 5, 16385 and off a multiple of
    4, T = 1, 31, 32, 33, 513 (each occ load path: a multiple of 32, at most
    32, any other; several register chunks), R one past a block's rows."""
    import chip_smoke

    Ws = {c[0] for c in chip_smoke.AFFINITY_CASES}
    Ts = {c[1] for c in chip_smoke.AFFINITY_CASES}
    Rs = {c[2] for c in chip_smoke.AFFINITY_CASES}
    assert {1, 3, 5, 16385} <= Ws and any(w % 4 for w in Ws if w > 4)
    assert {1, 31, 32, 33, 513} <= Ts
    assert any(t % 32 == 0 and (t + 31) // 32 > 8 for t in Ts)
    assert kernel.BLOCK_ROWS + 1 in Rs
    assert any(r > 2 * kernel.BLOCK_ROWS for r in Rs)


def test_every_probe_variant_still_applies_to_the_source():
    """tools/affinity_variants.py's text substitutions all match the
    current affinity_common.cuh, so the probe builds every variant."""
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "tools" / \
        "affinity_variants.py"
    spec = importlib.util.spec_from_file_location("affinity_variants", path)
    affinity_variants = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(affinity_variants)
    for name in affinity_variants.VARIANTS:
        text = affinity_variants.variant_text(name)
        assert (name == "kernel") == (
            text == (CSRC / "affinity_common.cuh").read_text())
