"""The port's flash attention and attention switch against the JAX
package's, on the CPU (where the port runs the kernel's plain PyTorch
version and the reference runs its Pallas kernel in interpret mode).

Inputs are drawn with numpy from a seed and handed to both sides.
Tolerances are those of ``tests/test_kernels.py`` for the flash kernel:
2e-5 in float32, 5e-2 in bfloat16 (both sides round the output to bf16
once; the two can differ by one bf16 step).  The attention switch is held
to 1e-5 in float32: the same maths, summed in another order."""
import os
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# torch's intra-op threads: this pytest-xdist worker's share of the cores
torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", 1))))

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.models import attention as port_attn  # noqa: E402

_DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                     torch.bfloat16)}


def qkv(seed, B, Sq, Skv, H, K, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd), dtype=np.float32),
            rng.standard_normal((B, Skv, K, hd), dtype=np.float32),
            rng.standard_normal((B, Skv, K, hd), dtype=np.float32))


def both(arrays, dt):
    jdt, tdt = _DT[dt]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def err(jax_out, torch_out) -> float:
    return float(np.max(np.abs(np.asarray(jax_out, np.float32)
                               - torch_out.float().numpy())))


@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,causal,window,dt,tol", [
    # the five shapes of tests/test_kernels.py, with their tolerances
    (2, 128, 128, 4, 2, 64, True, None, "f32", 2e-5),
    (1, 256, 256, 8, 8, 32, True, 64, "f32", 2e-5),
    (2, 200, 200, 4, 1, 64, True, None, "bf16", 5e-2),
    (1, 128, 384, 4, 2, 64, False, None, "f32", 2e-5),
    (1, 384, 384, 2, 2, 128, True, 100, "f32", 2e-5),
    # gemma3-like: GQA 8:4, head_dim 256, sliding window, ragged length
    (1, 300, 300, 8, 4, 256, True, 64, "f32", 2e-5),
    # causal + window at ragged Sq != Skv: the kernel's key-tile bounds
    (1, 300, 200, 8, 4, 256, True, 128, "f32", 2e-5),
    (1, 200, 300, 4, 2, 64, True, 50, "f32", 2e-5),
    # the moe and hybrid families' GQA ratios: 8 at head_dim 64
    # (qwen3-moe-30b-a3b's 32:4) and 7 at head_dim 128 (arctic-480b's 56:8)
    (1, 200, 200, 32, 4, 64, True, None, "f32", 2e-5),
    (1, 130, 130, 56, 8, 128, True, None, "f32", 2e-5),
])
def test_flash_attention_equals_the_reference(B, Sq, Skv, H, K, hd, causal,
                                              window, dt, tol):
    (jq, jk, jv), (tq, tk, tv) = both(
        qkv(Sq * 7 + hd, B, Sq, Skv, H, K, hd), dt)
    want = jax_flash(jq, jk, jv, causal=causal, window=window, bq=128,
                     bk=128)
    got = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert err(want, got) < tol
    assert torch.equal(fa_ops.flash_attention_ref(tq, tk, tv, causal=causal,
                                                  window=window), got)


@pytest.mark.parametrize("impl", ["direct", "chunked", "chunked2d", "flash"])
@pytest.mark.parametrize("S,window,q_block", [(320, None, 64),
                                              (320, 48, 64),
                                              (320, None, 128),
                                              (128, 16, 64)])
def test_attention_switch_equals_the_reference(impl, S, window, q_block):
    """Every ``impl`` at S = 320 (past the 256 x 256 direct-path rule, so
    the chosen path is really taken; q_block 128 does not divide 320, so
    chunked2d falls back to chunked) and at S = 128 (where every impl takes
    the direct path)."""
    B, H, K, hd = 1, 4, 2, 32
    (jq, jk, jv), (tq, tk, tv) = both(qkv(S + (window or 0), B, S, S, H, K,
                                          hd), "f32")
    pos_j = jnp.arange(S, dtype=jnp.int32)
    pos_t = torch.arange(S, dtype=torch.int32)
    kw = dict(causal=True, window=window, impl=impl, chunk=64,
              q_block=q_block)
    want = jax_attn.attention(jq, jk, jv, pos_j, pos_j, **kw)
    got = port_attn.attention(tq, tk, tv, pos_t, pos_t, **kw)
    assert err(want, got) < 1e-5


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 40), (False, 40)])
def test_chunked_paths_equal_the_reference_at_ragged_lengths(causal, window):
    """Sq != Skv and Skv not a multiple of the chunk (the padded last
    chunk), for the chunked paths the switch can take."""
    B, Sq, Skv, H, K, hd = 1, 192, 300, 4, 1, 16
    (jq, jk, jv), (tq, tk, tv) = both(qkv(5, B, Sq, Skv, H, K, hd), "f32")
    pq_j, pk_j = jnp.arange(Sq, dtype=jnp.int32), jnp.arange(Skv,
                                                            dtype=jnp.int32)
    pq_t, pk_t = torch.arange(Sq, dtype=torch.int32), torch.arange(
        Skv, dtype=torch.int32)
    for fn in ("attention_chunked", "attention_chunked2d"):
        kw = dict(causal=causal, window=window, chunk=64)
        if fn == "attention_chunked2d":
            kw["q_block"] = 64
        want = getattr(jax_attn, fn)(jq, jk, jv, pq_j, pk_j, **kw)
        got = getattr(port_attn, fn)(tq, tk, tv, pq_t, pk_t, **kw)
        assert err(want, got) < 1e-5, fn


def test_bf16_chunked_path_equals_the_reference():
    """bf16 inputs through the chunked path: probabilities rounded to bf16
    before the product with v, as the reference does."""
    (jq, jk, jv), (tq, tk, tv) = both(qkv(9, 1, 320, 320, 4, 2, 32), "bf16")
    pj, pt = jnp.arange(320, dtype=jnp.int32), torch.arange(
        320, dtype=torch.int32)
    want = jax_attn.attention_chunked(jq, jk, jv, pj, pj, chunk=64)
    got = port_attn.attention_chunked(tq, tk, tv, pt, pt, chunk=64)
    assert got.dtype == torch.bfloat16
    assert err(want, got) < 5e-2


def test_cpu_tensors_take_the_plain_version_and_nothing_else(monkeypatch):
    """A CPU tensor runs the plain version; a tensor elsewhere reaches
    neither it nor the kernel; the kernel wrapper refuses host tensors and
    what the kernel does not take, and counts no launch."""
    calls = []
    monkeypatch.setattr(fa_ops, "flash_attention_ref",
                        lambda *a, **k: calls.append("ref"))
    monkeypatch.setattr(fa_ops, "flash_attention_kernel",
                        lambda *a, **k: calls.append("kernel"))
    _, (tq, tk, tv) = both(qkv(1, 1, 8, 8, 2, 1, 64), "f32")
    fa_ops.flash_attention(tq, tk, tv)
    assert calls == ["ref"]
    meta = torch.zeros((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa_ops.flash_attention(meta, meta[:, :, :1], meta[:, :, :1])
    with pytest.raises(TypeError, match="backend"):
        fa_ops.flash_attention(tq, tk, tv, backend="ref")
    assert calls == ["ref"]
    before = fa_kernel.KERNEL.launches
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        fa_kernel.flash_attention_kernel(tq, tk, tv)
    assert fa_kernel.KERNEL.launches == before


@pytest.mark.parametrize("shape_q,shape_kv,dtype,window,match", [
    ((1, 8, 2, 32), (1, 8, 1, 32), torch.float32, None, "head_dim 32"),
    ((1, 8, 3, 64), (1, 8, 2, 64), torch.float32, None, "do not group"),
    ((1, 8, 2, 64), (1, 8, 1, 64), torch.float16, None, "float32 or bf"),
    ((1, 8, 2, 64), (1, 8, 1, 64), torch.float32, 0, "window must be"),
    ((1, 8, 2, 64), (1, 9, 1, 128), torch.float32, None, "must be"),
    ((1, 12, 2, 64), (1, 8, 1, 64), torch.float32, 4, "see no key"),
])
def test_kernel_wrapper_refuses_what_the_kernel_cannot_take(
        shape_q, shape_kv, dtype, window, match):
    q = torch.zeros(shape_q, dtype=dtype)
    kv = torch.zeros(shape_kv, dtype=dtype)
    with pytest.raises((ValueError, TypeError), match=match):
        fa_kernel.check_shapes(q, kv, kv, window)



def test_bf16_tiles_are_the_sources():
    """``kernel.TILES`` is what ``flash_attention_sm90.cu``'s ``Tiles<HD>``
    compiles (the card's tests read it back from the library too): 64 query
    rows a consumer warpgroup, 64 or 128 keys a tile."""
    src = (Path(fa_kernel.__file__).parent / "csrc" /
           "flash_attention_sm90.cu").read_text()
    found = {int(hd): fa_kernel.Tiles(*map(int, args))
             for hd, *args in re.findall(
                 r"struct Tiles<(\d+)> : TilesOf<(\d+), (\d+), (\d+), "
                 r"(\d+),", src)}
    assert found == fa_kernel.TILES
    assert set(found) == set(fa_kernel.HEAD_DIMS)
    for t in found.values():
        assert t.rows == 64 * t.consumers and t.keys in (64, 128)


def test_f32_tiles_are_the_sources():
    """``kernel.F32_TILES`` is what ``flash_attention.cu``'s ``Tiles<HD>``
    compiles (the card's tests read it back from the library too): 2048 /
    hd query rows a warp, 64 keys a tile, 8 warps an SM."""
    src = (Path(fa_kernel.__file__).parent / "csrc" /
           "flash_attention.cu").read_text()
    found = {int(hd): fa_kernel.F32Tiles(*map(int, args))
             for hd, h2, *args in re.findall(
                 r"struct Tiles<(\d+)> : TilesOf<(\d+), (\d+), (\d+), "
                 r"(\d+), (\d+),", src) if hd == h2}
    assert found == fa_kernel.F32_TILES
    assert set(found) == set(fa_kernel.HEAD_DIMS)
    for hd, t in found.items():
        assert t.rows == 2048 // hd * t.threads // 32 and t.keys == 64
        assert t.threads * t.ctas_per_sm == 256


@pytest.mark.parametrize("hd", fa_kernel.HEAD_DIMS)
def test_flash_cases_cover_each_head_dims_f32_tiles(hd):
    """``chip_smoke.FLASH_CASES``, which the card's runs hold the float32
    kernel to, reach every edge of head dim ``hd``'s float32 tiles: an Sq
    off its query rows that leaves a warp part full, an Skv off its key
    tile and a window under its key tile."""
    import chip_smoke

    t = fa_kernel.F32_TILES[hd]
    warp_rows = 2048 // hd
    cases = [c for c in chip_smoke.FLASH_CASES if c[5] == hd]
    assert any(Sq % t.rows % warp_rows for _, Sq, *_ in cases)
    assert any(Skv % t.keys for _, _, Skv, *_ in cases)
    assert any(w is not None and w < t.keys for *_, w in cases)


def _consumer_boundary_on_diagonal(rows, Sq, Skv, causal) -> bool:
    """A causal case whose diagonal runs from one consumer's 64 rows into
    the next one's inside a CTA of ``rows`` rows."""
    return causal and any(b % rows for b in range(64, min(Sq, Skv), 64))


@pytest.mark.parametrize("hd", fa_kernel.HEAD_DIMS)
def test_flash_cases_cover_each_head_dims_tiles(hd):
    """``chip_smoke.FLASH_CASES``, which the card's runs hold the bf16
    kernel to, reach every edge of head dim ``hd``'s tiles: an Sq off its
    query rows, an Skv off its key tile, a window under its key tile and a
    causal diagonal across a consumer boundary."""
    import chip_smoke

    t = fa_kernel.TILES[hd]
    cases = [c for c in chip_smoke.FLASH_CASES if c[5] == hd]
    assert any(Sq % t.rows for _, Sq, *_ in cases)
    assert any(Skv % t.keys for _, _, Skv, *_ in cases)
    assert any(w is not None and w < t.keys for *_, w in cases)
    assert any(_consumer_boundary_on_diagonal(t.rows, Sq, Skv, causal)
               for _, Sq, Skv, _, _, _, causal, _ in cases)


@pytest.mark.parametrize("rows,Sq,Skv,causal,crosses", [
    (128, 64, 64, True, False),    # one consumer's rows only
    (128, 65, 65, True, True),     # row 64 starts the second consumer
    (128, 65, 64, True, False),    # no key past 63: the diagonal ends
    (128, 200, 200, False, False),  # no diagonal
    (192, 193, 193, True, True),
    (64, 300, 300, True, False),   # every boundary is a CTA's
])
def test_consumer_boundary_on_diagonal(rows, Sq, Skv, causal, crosses):
    assert _consumer_boundary_on_diagonal(rows, Sq, Skv, causal) == crosses


@pytest.mark.parametrize("dtype,hd,kernel", [
    (torch.bfloat16, 64, "flash_attention_bf16"),
    (torch.bfloat16, 128, "flash_attention_bf16"),
    (torch.bfloat16, 256, "flash_attention_bf16"),
    (torch.float32, 64, "flash_attention"),
    (torch.float32, 128, "flash_attention"),
    (torch.float32, 256, "flash_attention"),
])
def test_choose_kernel_routes_bf16_to_the_tensor_core_kernel(dtype, hd,
                                                             kernel):
    chosen = fa_kernel.choose_kernel(dtype, hd)
    assert chosen.name == kernel
    assert chosen in (fa_kernel.KERNEL, fa_kernel.KERNEL_BF16)


@pytest.mark.parametrize("dtype,hd,error,match", [
    (torch.float16, 128, TypeError, "float32 or bfloat16"),
    (torch.float64, 64, TypeError, "float32 or bfloat16"),
    (torch.int8, 256, TypeError, "float32 or bfloat16"),
    (torch.bfloat16, 32, ValueError, "head_dim 32"),
    (torch.bfloat16, 96, ValueError, "head_dim 96"),
    (torch.float32, 512, ValueError, "head_dim 512"),
])
def test_choose_kernel_refuses_other_types_and_head_dims(dtype, hd, error,
                                                         match):
    with pytest.raises(error, match=match):
        fa_kernel.choose_kernel(dtype, hd)


@pytest.mark.parametrize("Sq,Skv,causal,window,tile", [
    (300, 300, True, None, 0),
    (128, 384, False, None, 0),
    # window 1: every tile is seen by its own 64 rows, the first wins
    (300, 300, True, 1, 0),
    # window 128 over 1000 keys: tiles 0-12 are seen by 191 rows each
    (1000, 1000, True, 128, 0),
    # Sq < Skv, causal under a window: tiles 0 and 1 are seen by 113 rows
    # each (0-112, 64-176), tile 2 by 72
    (200, 300, True, 50, 0),
    # non-causal under a window: rows 0-162 see tile 0, all 200 rows see
    # tiles 1 and 2, so the first of those is dropped
    (200, 300, False, 100, 1),
])
def test_dropped_tile_is_the_one_most_rows_see(Sq, Skv, causal, window,
                                               tile):
    import chip_smoke

    assert chip_smoke.dropped_tile(Sq, Skv, causal, window) == tile


@pytest.mark.parametrize("Skv,causal,window,span", [
    # a causal mask or a window: one tile, which early rows see whole
    (2048, True, None, 1),
    (2048, False, 128, 1),
    # every row sees every key: a quarter of the tiles (32 / 4, 5 / 4 up)
    (2048, False, None, 8),
    (300, False, None, 2),
    (64, False, None, 1),
])
def test_dropped_span_is_a_share_of_the_keys_where_rows_see_all(
        Skv, causal, window, span):
    import chip_smoke

    assert chip_smoke.dropped_span(Skv, causal, window) == span


@pytest.mark.parametrize("Sq,Skv,causal,tile", [
    # the tile before the last row's diagonal tile (4, rows 256-299)
    (300, 300, True, 3),
    # Sq > Skv: the last row's diagonal is the last key, in tile 3
    (300, 200, True, 2),
    # Sq < Skv: the last row (199) sits in tile 3
    (200, 300, True, 2),
    # short rows: the diagonal tile is the first, so is the late one
    (1, 1, True, 0),
    (100, 100, True, 0),
    # non-causal: every row sees the last (ragged) tile
    (257, 100, False, 1),
    (128, 384, False, 5),
])
def test_late_tile_is_before_the_last_rows_diagonal(Sq, Skv, causal, tile):
    import chip_smoke

    assert chip_smoke.late_tile(Sq, Skv, causal) == tile


@pytest.mark.parametrize("hd", [256, 128])
@pytest.mark.parametrize("window", [None, 128])
@pytest.mark.parametrize("part", ["whole", "late"])
def test_bf16_tolerance_holds_p_rounding_and_sees_a_dropped_tile(hd, window,
                                                                 part):
    """The bf16 kernel's per-element tolerance
    (``chip_smoke.flash_bf16_bound``) on the CPU: the port's chunked path on
    bf16 inputs with 64-key chunks rounds p to bf16 before the product with
    v and o at the end, where the kernel does, and every element sits within
    its tolerance of the plain version on the inputs widened to float32;
    the plain version with one 64-key tile of v zeroed moves some element
    by more than 4x its tolerance (``flash_bf16_check`` raises otherwise).
    ``whole``: the inputs as drawn, the first or most-seen tile dropped;
    ``late``: v zeroed outside the tile before the last row's diagonal,
    which is then dropped.  At hd = 128 the chunked path also rounds
    q / sqrt(hd) to bf16 once, which the kernel does not."""
    import chip_smoke

    B, S, H, K = 1, 1000, 2, 1
    _, (tq, tk, tv) = both(qkv(hd + (window or 0), B, S, S, H, K, hd),
                           "bf16")
    if part == "whole":
        tile = chip_smoke.dropped_tile(S, S, True, window)
    else:
        tile = chip_smoke.late_tile(S, S, True)
        tv = chip_smoke.tile_rows(tv, tile, keep=True)
    pos = torch.arange(S, dtype=torch.int32)
    got = port_attn.attention_chunked(tq, tk, tv, pos, pos, causal=True,
                                      window=window, chunk=64)
    assert got.dtype == torch.bfloat16
    check = chip_smoke.flash_bf16_check(got, tq, tk, tv, True, window, tile)
    assert 0 < check["max_abs_err"] and check["err_over_tol"] <= 1
    assert check["drop_over_tol"] >= chip_smoke.FLASH_DROP
    assert check["tile"] == tile


@pytest.mark.parametrize("part", ["whole", "late"])
def test_bf16_check_refuses_an_output_that_left_out_the_tile(part):
    """An output computed with the control's tile of v left out (the
    chunked path on v with that tile zeroed) fails ``flash_bf16_check``:
    on the whole inputs for the first tile, and on v restricted to the late
    tile for that tile."""
    import chip_smoke

    S, window = 1000, None
    _, (tq, tk, tv) = both(qkv(7, 1, S, S, 2, 1, 256), "bf16")
    if part == "whole":
        tile = chip_smoke.dropped_tile(S, S, True, window)
    else:
        tile = chip_smoke.late_tile(S, S, True)
        tv = chip_smoke.tile_rows(tv, tile, keep=True)
    pos = torch.arange(S, dtype=torch.int32)
    got = port_attn.attention_chunked(
        tq, tk, chip_smoke.tile_rows(tv, tile, keep=False), pos, pos,
        causal=True, window=window, chunk=64)
    with pytest.raises(AssertionError, match="x the tolerance of an element"):
        chip_smoke.flash_bf16_check(got, tq, tk, tv, True, window, tile)


@pytest.mark.parametrize("how", ["positional", "keyword"])
def test_flash_attention_refuses_positions(how):
    """The kernel takes positions 0..S-1 only, so the entry has no position
    arguments: passing them is a TypeError, not a silently wrong answer."""
    _, (tq, tk, tv) = both(qkv(3, 1, 8, 8, 2, 1, 64), "f32")
    pos = torch.arange(8, dtype=torch.int32) + 5
    with pytest.raises(TypeError):
        if how == "positional":
            flash_attention(tq, tk, tv, pos, pos)
        else:
            flash_attention(tq, tk, tv, q_pos=pos, kv_pos=pos)
