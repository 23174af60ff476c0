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
import numpy as np
import pytest
import torch

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
    assert ms.KERNELS == (ms.SELECTIVE_SCAN_KERNEL,)


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
