"""The port's selective scan against the JAX package's, on the CPU (where the
port runs the kernel's plain PyTorch version and the reference runs its
oracle and its Pallas kernel in interpret mode).

Inputs are drawn with numpy from a seed, as ``tests/test_kernels.py`` draws
them (dt = 0.1 softplus(normal), x, B, C normal, A = -exp(normal)), and
handed to both sides.  The tolerance is that file's 1e-4 absolute: the same
float32 recurrence, its sum over N taken in another order.  bfloat16 inputs
are widened to float32 on entry on both the port's side and the Pallas
kernel's, so they are held to the same 1e-4.  Then the wrapper's refusals,
and its routes: a CPU tensor reaches the plain version only, the kernel
wrapper refuses a host tensor, and another device reaches neither."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# torch's intra-op threads: this pytest-xdist worker's share of the cores
torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", 1))))

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.mamba_scan import selective_scan as jax_scan  # noqa: E402
from repro.kernels.mamba_scan import selective_scan_ref as jax_scan_ref  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.kernels.mamba_scan import kernel as ms_kernel  # noqa: E402
from repro_torch.kernels.mamba_scan import ops as ms_ops  # noqa: E402
from repro_torch.kernels.mamba_scan import selective_scan  # noqa: E402

TOL = 1e-4

#: (B, S, D, N, chunk, bd): the four shapes of tests/test_kernels.py, with
#: the reference's Pallas tiling (the port's wrapper takes none)
SWEEP = [(2, 64, 32, 4, 16, 16), (1, 100, 48, 16, 32, 16),
         (2, 128, 64, 8, 64, 64), (1, 48, 16, 2, 48, 16)]


def inputs(seed, B, S, D, N):
    rng = np.random.default_rng(seed)
    dt = (0.1 * np.logaddexp(rng.standard_normal((B, S, D)), 0.0)
          ).astype(np.float32)
    x = rng.standard_normal((B, S, D), dtype=np.float32)
    b = rng.standard_normal((B, S, N), dtype=np.float32)
    c = rng.standard_normal((B, S, N), dtype=np.float32)
    a = -np.exp(rng.standard_normal((D, N), dtype=np.float32))
    return dt, x, b, c, a


def err(jax_out, torch_out) -> float:
    return float(np.max(np.abs(np.asarray(jax_out, np.float32)
                               - torch_out.numpy())))


@pytest.mark.parametrize("B,S,D,N,chunk,bd", SWEEP)
def test_plain_scan_equals_the_reference_oracle_and_pallas_kernel(
        B, S, D, N, chunk, bd):
    arrays = inputs(B * 1000 + S + N, B, S, D, N)
    j = [jnp.asarray(a) for a in arrays]
    got = selective_scan(*(torch.from_numpy(a) for a in arrays))
    assert got.shape == (B, S, D) and got.dtype == torch.float32
    assert err(jax_scan_ref(*j), got) < TOL
    assert err(jax_scan(*j, chunk=chunk, bd=bd), got) < TOL
    # backend="ref" is the same plain version
    assert torch.equal(selective_scan(*(torch.from_numpy(a) for a in arrays),
                                      backend="ref"), got)


@pytest.mark.parametrize("B,S,D,N", [(2, 64, 32, 4), (1, 100, 48, 16)])
def test_bfloat16_inputs_are_widened_as_the_pallas_kernel_widens_them(
        B, S, D, N):
    """dt, x, b, c in bfloat16, a float32: both sides widen on entry, so
    they agree with each other and with the float32 oracle on the widened
    values."""
    dt, x, b, c, a = inputs(7 + N, B, S, D, N)
    jb = [jnp.asarray(t).astype(jnp.bfloat16) for t in (dt, x, b, c)]
    tb = [torch.from_numpy(t).to(torch.bfloat16) for t in (dt, x, b, c)]
    got = selective_scan(*tb, torch.from_numpy(a))
    assert got.dtype == torch.float32
    assert err(jax_scan(*jb, jnp.asarray(a), chunk=16, bd=16), got) < TOL
    widened = [t.astype(jnp.float32) for t in jb]
    assert err(jax_scan_ref(*widened, jnp.asarray(a)), got) < TOL
    # mixed types, as the model passes them: dt float32, the rest bf16
    mixed = selective_scan(torch.from_numpy(dt), *tb[1:], torch.from_numpy(a))
    assert err(jax_scan_ref(jnp.asarray(dt), *widened[1:], jnp.asarray(a)),
               mixed) < TOL


def _small(N=4, dtype=torch.float32):
    dt, x, b, c, a = (torch.from_numpy(t) for t in inputs(0, 1, 8, 6, N))
    return dt.to(dtype), x.to(dtype), b.to(dtype), c.to(dtype), a


@pytest.mark.parametrize("N", [3, 64])
def test_the_wrapper_refuses_an_unsupported_state_size(N):
    with pytest.raises(ValueError, match=f"state size N = {N}"):
        selective_scan(*_small(N))
    with pytest.raises(ValueError, match=f"state size N = {N}"):
        selective_scan(*_small(N), backend="ref")


def test_the_wrapper_refuses_other_dtypes_and_shapes():
    dt, x, b, c, a = _small()
    with pytest.raises(TypeError, match="x must be float32 or bfloat16"):
        selective_scan(dt, x.half(), b, c, a)
    with pytest.raises(TypeError, match="a must be float32"):
        selective_scan(dt, x, b, c, a.to(torch.bfloat16))
    with pytest.raises(TypeError, match="dt must be float32 or bfloat16"):
        selective_scan(dt.double(), x, b, c, a)
    with pytest.raises(ValueError, match="x .* must match dt"):
        selective_scan(dt, x[:, :4], b, c, a)
    with pytest.raises(ValueError, match=r"must be \[B, S, N\]"):
        selective_scan(dt, x, b[:, :, :2], c, a)
    with pytest.raises(ValueError, match=r"must be \[D, N\]"):
        selective_scan(dt, x, b, c, a[:3])
    with pytest.raises(ValueError, match="b must be 3-d"):
        selective_scan(dt, x, b[0], c, a)
    with pytest.raises(ValueError, match="unknown backend"):
        selective_scan(dt, x, b, c, a, backend="pallas")


def test_an_empty_sequence_gives_an_empty_output():
    dt, x, b, c, a = _small()
    y = selective_scan(dt[:, :0], x[:, :0], b[:, :0], c[:, :0], a)
    assert y.shape == (1, 0, 6) and y.dtype == torch.float32


def test_the_routes(monkeypatch):
    """A CPU tensor reaches the plain version and never the kernel; the
    kernel wrapper refuses host tensors without counting a launch; a tensor
    on another device reaches neither."""
    calls = []
    monkeypatch.setattr(ms_ops, "selective_scan_kernel",
                        lambda *a: calls.append("kernel"))
    ms_ops.selective_scan(*_small())
    assert calls == []
    before = ms.SELECTIVE_SCAN_KERNEL.launches
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        ms_kernel.selective_scan_kernel(*_small())
    assert ms.SELECTIVE_SCAN_KERNEL.launches == before
    monkeypatch.setattr(ms_ops, "selective_scan_ref",
                        lambda *a: calls.append("ref"))
    meta = [t.to("meta") for t in _small()]
    with pytest.raises(ValueError, match="unsupported device"):
        ms_ops.selective_scan(*meta)
    assert calls == []
    assert ms.KERNELS == (ms.SELECTIVE_SCAN_KERNEL,
                          ms.SELECTIVE_SCAN_FUSED_KERNEL,
                          ms.CAUSAL_CONV_KERNEL)


def test_the_kernel_tiling_mirrors_the_cuda_source_and_the_card_cases_cover_it():
    """``kernel.py``'s tiling constants are the ``.cu``'s ``constexpr``s, and
    ``chip_smoke.SCAN_CASES`` (the cases the card checks) reach S below one
    chunk, S and D off a chunk and a tile multiple, D below one tile, both
    staging routes (D a multiple of 8 or not), both input types, and every
    state size, so every K instance."""
    import re
    from pathlib import Path

    import chip_smoke

    src = (Path(ms_kernel.__file__).parent / "csrc" / "selective_scan.cu"
           ).read_text()
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kT"] == ms_kernel.CHUNK
    assert consts["kCh"] == ms_kernel.CHANNEL_TILE
    assert consts["kU"] == ms_kernel.GROUP
    assert consts["kMaxStatesPerThread"] == ms_kernel.MAX_STATES_PER_THREAD
    for n in ms_kernel.STATE_DIMS:
        k = ms_kernel.states_per_thread(n)
        assert n % k == 0 and ms_kernel.GROUP % (n // k) == 0
    cases = chip_smoke.SCAN_CASES
    chunk, tile = ms_kernel.CHUNK, ms_kernel.CHANNEL_TILE
    assert any(S < chunk for _, S, _, _, _ in cases)
    assert any(S > chunk and S % chunk for _, S, _, _, _ in cases)
    assert any(S % ms_kernel.GROUP for _, S, _, _, _ in cases)
    assert any(D > tile and D % tile for _, _, D, _, _ in cases)
    assert any(D < tile for _, _, D, _, _ in cases)
    assert any(D % 8 == 0 for _, _, D, _, _ in cases)
    assert any(D % 8 for _, _, D, _, _ in cases)
    assert {dtype for *_, dtype in cases} == {"float32", "bfloat16"}
    assert {N for _, _, _, N, _ in cases} == set(ms_kernel.STATE_DIMS)
    # the long-memory case runs over four chunks or more, off a chunk
    # multiple, and its control cuts at a chunk boundary
    _, S, D, N = chip_smoke.SCAN_LONG
    assert S >= 4 * chunk and S % chunk and D % tile
    assert chip_smoke.SCAN_CUT % chunk == 0 and 0 < chip_smoke.SCAN_CUT < S


def test_the_long_memory_control_sees_a_lost_carry():
    """The plain version at the card's long-memory shape (a = -0.01
    exp(normal), ``chip_smoke.SCAN_LONG``), run in two halves with the state
    reset at ``SCAN_CUT``, differs from the whole run by more than
    ``SCAN_CARRY`` x the check's tolerance: a kernel that lost its carry
    between chunks could not pass that check."""
    import chip_smoke

    B, S, D, N = chip_smoke.SCAN_LONG
    dt, x, b, c, a = (torch.from_numpy(t) for t in inputs(11, B, S, D, N))
    a = a * chip_smoke.SCAN_LONG_A
    whole = selective_scan(dt, x, b, c, a)
    cut = chip_smoke.SCAN_CUT
    halves = torch.cat([selective_scan(dt[:, sl], x[:, sl], b[:, sl],
                                       c[:, sl], a)
                        for sl in (slice(0, cut), slice(cut, None))], dim=1)
    tol = chip_smoke.SCAN_TOL * max(1.0, float(whole.abs().max()))
    assert float((whole - halves).abs().max()) >= chip_smoke.SCAN_CARRY * tol
    assert torch.equal(whole[:, :cut], halves[:, :cut])


def test_every_probe_variant_applies_to_the_kernel_source():
    """``tools/scan_variants.py`` derives its variants by text substitution;
    each substitution must still match the kernel's source and change it."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / "scan_variants.py"
    spec = importlib.util.spec_from_file_location("scan_variants", path)
    sv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sv)
    src = sv.SOURCE.read_text()
    for name in sv.VARIANTS:
        text = sv.variant_text(name)
        assert (text == src) == (not sv.VARIANTS[name])


# --------------------------------------------------------------------------- #
# the block's two further entries: the conv kernel and the scan's second
# entry, their plain versions against the block's plain chain
# --------------------------------------------------------------------------- #


def _block_inputs(seed, B, S, D, N, dtype, dtr=3):
    """The fused entry's inputs as the block makes them: z the second half
    of an in_proj-shaped [B, S, 2D] product, b and c slices of an
    x_proj-shaped [B, S, dtr + 2N] one (views, read in place); dt_proj
    large enough at a few places that dt_proj + dt_b passes softplus's
    threshold of 20."""
    g = torch.Generator().manual_seed(seed)
    xz = torch.randn((B, S, 2 * D), generator=g).to(dtype)
    proj = torch.randn((B, S, dtr + 2 * N), generator=g).to(dtype)
    dt_proj = torch.randn((B, S, D), generator=g)
    dt_proj[:, ::3, ::2] += 25.0
    dt_b = 0.1 * torch.randn((D,), generator=g)
    a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32)).repeat(
        D, 1) + 0.1 * torch.randn((D, N), generator=g)
    d_skip = 1.0 + 0.1 * torch.randn((D,), generator=g)
    x = torch.nn.functional.silu(xz[..., :D].float()).to(dtype)
    _, b, c = proj.split([dtr, N, N], dim=-1)
    return (dt_proj.to(dtype), dt_b.to(dtype), x, xz[..., D:], b, c, a_log,
            d_skip)


def _chain(dt_proj, dt_b, x, z, b, c, a_log, d_skip):
    """The block's plain chain around the first scan entry."""
    F = torch.nn.functional
    dt = F.softplus(dt_proj.float() + dt_b.float())
    y = selective_scan(dt, x, b, c, -torch.exp(a_log))
    y = y + d_skip * x.float()
    return (y * F.silu(z.float())).to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("S", [1, 3, 40])
def test_the_conv_plain_version_equals_the_blocks_chain(S, dtype):
    """On a view of a [B, S, 2 di] product (rows of 2 di): bit for bit the
    block's ``causal_conv`` then SiLU in float32 and the cast, also where
    S is shorter than the conv's width."""
    from repro_torch.models.ssm import causal_conv

    g = torch.Generator().manual_seed(S)
    xz = torch.randn((2, S, 2 * 24), generator=g).to(dtype)
    w = torch.randn((24, 4), generator=g).to(dtype)
    b = torch.randn((24,), generator=g).to(dtype)
    xr = xz[..., :24]
    want = torch.nn.functional.silu(
        causal_conv(xr, w, b)[0].float()).to(dtype)
    got = ms.causal_conv_silu(xr, w, b)
    assert got.dtype == dtype and got.is_contiguous()
    assert torch.equal(got, want)
    assert torch.equal(ms.causal_conv_silu(xr, w, b, backend="ref"), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,D,N", [(1, 40, 24, 4), (2, 70, 16, 16)])
def test_the_fused_scan_plain_version_equals_the_blocks_chain(B, S, D, N,
                                                              dtype):
    """softplus (past its threshold too) -> the scan -> D skip -> gate ->
    cast, on the block's views: bit for bit."""
    ins = _block_inputs(B + S + N, B, S, D, N, dtype)
    assert float((ins[0].float() + ins[1].float()).max()) > 20.0
    got = ms.selective_scan_fused(*ins)
    assert got.dtype == dtype and got.shape == (B, S, D)
    assert torch.equal(got, _chain(*ins))
    assert torch.equal(ms.selective_scan_fused(*ins, backend="ref"), got)
    # and the plain version agrees with the first entry's oracle on the
    # widened inputs, the reference's scan
    dt_proj, dt_b, x, z, b, c, a_log, d_skip = ins
    dt = torch.nn.functional.softplus(dt_proj.float() + dt_b.float())
    y = jax_scan_ref(*(jnp.asarray(t.float().numpy()) for t in (
        dt, x, b, c, -torch.exp(a_log))))
    want = (torch.from_numpy(np.array(y)) + d_skip * x.float()) * \
        torch.nn.functional.silu(z.float())
    assert float((got.float() - want.to(dtype).float()).abs().max()) <= \
        TOL * max(1.0, float(want.abs().max())) + (
            0.0 if dtype == torch.float32
            else 2.0 ** -8 * float(want.abs().max()))


def _conv_small(dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    return (torch.randn((1, 6, 8), generator=g).to(dtype),
            torch.randn((8, 4), generator=g).to(dtype),
            torch.randn((8,), generator=g).to(dtype))


def test_the_block_entries_refuse_autograd_and_other_types():
    conv, fused = _conv_small(), _block_inputs(0, 1, 8, 8, 4, torch.float32)
    with pytest.raises(RuntimeError, match="causal_conv_silu is forward-only"):
        ms.causal_conv_silu(conv[0].requires_grad_(), *conv[1:])
    with pytest.raises(RuntimeError,
                       match="selective_scan_fused is forward-only"):
        ms.selective_scan_fused(*fused[:6],
                                fused[6].clone().requires_grad_(), fused[7])
    x, w, b = _conv_small()
    with pytest.raises(TypeError, match="x must be float32 or bfloat16"):
        ms.causal_conv_silu(x.half(), w.half(), b.half())
    with pytest.raises(TypeError, match="w must be torch.float32 like x"):
        ms.causal_conv_silu(x, w.to(torch.bfloat16), b)
    for kw in (3, 5):
        with pytest.raises(ValueError, match=f"conv width kw = {kw}"):
            ms.causal_conv_silu(x, torch.zeros((8, kw)), b)
    with pytest.raises(ValueError, match=r"must be \[D, kw\] and \[D\]"):
        ms.causal_conv_silu(x, w[:4], b)
    dt_proj, dt_b, x, z, b, c, a_log, d_skip = fused
    with pytest.raises(TypeError, match="z must be torch.float32 like x"):
        ms.selective_scan_fused(dt_proj, dt_b, x, z.to(torch.bfloat16), b, c,
                                a_log, d_skip)
    with pytest.raises(TypeError, match="d_skip must be float32"):
        ms.selective_scan_fused(dt_proj, dt_b, x, z, b, c, a_log,
                                d_skip.double())
    with pytest.raises(TypeError, match="x must be float32 or bfloat16"):
        ms.selective_scan_fused(*(t.half() for t in fused[:6]), a_log,
                                d_skip)
    with pytest.raises(ValueError, match=r"b \(1, 8, 2\) must be"):
        ms.selective_scan_fused(dt_proj, dt_b, x, z, b[..., :2], c, a_log,
                                d_skip)
    with pytest.raises(ValueError, match="state size N = 3"):
        ms.selective_scan_fused(dt_proj, dt_b, x, z, b[..., :3], c[..., :3],
                                a_log[:, :3], d_skip)
    with pytest.raises(ValueError, match="unknown backend"):
        ms.causal_conv_silu(*_conv_small(), backend="triton")


@pytest.fixture
def one_rank_mesh():
    """A device mesh over a fake process group of two ranks, this process
    rank 0: enough to make DTensors, with no communication."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        yield init_device_mesh("cpu", (2,))
    finally:
        dist.destroy_process_group()


def test_the_block_entries_refuse_dtensors(one_rank_mesh):
    from torch.distributed.tensor import DTensor, Replicate

    def dtensor(t):
        return DTensor.from_local(t, one_rank_mesh, [Replicate()])

    x, w, b = _conv_small()
    with pytest.raises(TypeError, match="causal_conv_silu takes plain "
                                        "tensors, not DTensors"):
        ms.causal_conv_silu(dtensor(x), w, b)
    fused = list(_block_inputs(0, 1, 8, 8, 4, torch.float32))
    fused[3] = dtensor(fused[3].contiguous())
    with pytest.raises(TypeError, match="selective_scan_fused takes plain "
                                        "tensors, not DTensors"):
        ms.selective_scan_fused(*fused)


def test_the_block_entries_routes(monkeypatch):
    """CPU tensors reach the plain versions and never the kernels; the
    kernel wrappers refuse host tensors without counting a launch; a tensor
    on another device reaches neither."""
    calls = []
    for name in ("causal_conv_silu_kernel", "selective_scan_fused_kernel"):
        monkeypatch.setattr(ms_ops, name,
                            lambda *a, name=name: calls.append(name))
    conv, fused = _conv_small(), _block_inputs(0, 1, 8, 8, 4, torch.float32)
    assert ms_ops.causal_conv_silu(*conv).shape == (1, 6, 8)
    assert ms_ops.selective_scan_fused(*fused).shape == (1, 8, 8)
    assert calls == []
    before = [k.launches for k in ms.KERNELS]
    with pytest.raises(ValueError, match="x must be a CUDA tensor"):
        ms_kernel.causal_conv_silu_kernel(*conv)
    with pytest.raises(ValueError, match="dt_proj must be a CUDA tensor"):
        ms_kernel.selective_scan_fused_kernel(*fused)
    assert [k.launches for k in ms.KERNELS] == before
    for name in ("causal_conv_silu_ref", "selective_scan_fused_ref"):
        monkeypatch.setattr(ms_ops, name,
                            lambda *a, name=name: calls.append(name))
    with pytest.raises(ValueError, match="unsupported device"):
        ms_ops.causal_conv_silu(*(t.to("meta") for t in conv))
    with pytest.raises(ValueError, match="unsupported device"):
        ms_ops.selective_scan_fused(*(t.to("meta") for t in fused))
    assert calls == []


def test_each_scan_entry_has_a_library_of_its_own():
    """The one source is built twice: the default build holds the first
    entry, a build with SCAN_FUSED_ENTRY the second, so no two libraries
    hold the same kernel instances; the source guards each entry so.  The
    conv kernel's taps are built without FMA contraction."""
    from pathlib import Path

    from repro_torch.kernels.build import EXACT_FLAGS

    first, fused = ms.SELECTIVE_SCAN_KERNEL, ms.SELECTIVE_SCAN_FUSED_KERNEL
    assert fused.source == first.source and fused.entry != first.entry
    assert fused.flags == first.flags + ("-DSCAN_FUSED_ENTRY",)
    assert fused.library_path() != first.library_path()
    src = Path(first.source).read_text()
    guard, other, end = (src.index(t) for t in (
        "#ifndef SCAN_FUSED_ENTRY", "#else", "#endif  // SCAN_FUSED_ENTRY"))
    assert guard < src.index(f'extern "C" int {first.entry}(') < other
    assert other < src.index(f'extern "C" int {fused.entry}(') < end
    assert ms.CAUSAL_CONV_KERNEL.flags == EXACT_FLAGS
