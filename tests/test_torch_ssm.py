"""The port's mamba-1 path against the JAX package's, on the CPU, with the
reference's parameters carried across by ``model_params_from_jax``.

falcon-mamba-7b ``reduced()`` (2 mamba layers, d_model 64, d_inner 128,
N = 4, dt_rank 8, float32), also with ``d_ff = 0`` as the full model has
it: the mamba block's prefill and decode step, then the whole model's
prefill logits and decode steps from an empty cache, against the
reference's chunked scan (``scan_chunk = 16``) and its unchunked one
(``scan_chunk = 0``).  The port runs the scan kernel's plain version here.
Everything is held to 1e-4 absolute: the same float32 maths, summed in
another order.  The differentiable scan (``scan_impl="chunked"``, the
train path's) is held to the reference's ``mamba_forward`` on the same
1e-4: chunked and unchunked, a sequence off the chunk (zero padding), and
bfloat16 scan intermediates, which the port forms in the reference's
combine order.  Then the conversion of a bfloat16 model, which keeps the
reference's float32 ``a_log`` and ``d_skip``."""
import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# torch's intra-op threads: this pytest-xdist worker's share of the cores
torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", 1))))

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.models import init_cache as jax_init_cache  # noqa: E402
from repro.models import init_model as jax_init_model  # noqa: E402
from repro.models import model_decode_step as jax_decode  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.train.step import make_prefill_step as jax_prefill_step  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.convert import model_params_from_jax  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.models import init_cache, init_model  # noqa: E402
from repro_torch.models import ssm as port_ssm  # noqa: E402
from repro_torch.train.step import (make_prefill_step,  # noqa: E402
                                    make_serve_step)

TOL = 1e-4
ARCH = "falcon-mamba-7b"


def configs(**over):
    return (dataclasses.replace(JAX_ARCHS[ARCH].reduced(), **over),
            dataclasses.replace(ARCHS[ARCH].reduced(), **over))


def ssm_params(jcfg, seed: int):
    """The reference's parameter pytree for ``jcfg`` (its structure from
    ``init_model``, traced, not run), filled from a numpy seed: matrices
    N(0, 1/fan_in), embeddings N(0, 1), norm gains and ``d_skip`` near 1,
    biases near 0, ``a_log`` near the S4D-real log(1..N) — non-trivial
    everywhere, so every leaf's conversion shows.  Each leaf keeps the
    reference's dtype."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(functools.partial(jax_init_model, jcfg),
                            jax.random.PRNGKey(0))

    def draw(path, leaf):
        name = getattr(path[-1], "key", "")
        x = rng.standard_normal(leaf.shape, dtype=np.float32)
        if name in ("w", "d_skip"):
            x = 1.0 + 0.1 * x
        elif name in ("conv_b", "dt_b"):
            x = 0.1 * x
        elif name == "a_log":
            x = np.log(np.arange(1, leaf.shape[-1] + 1, dtype=np.float32)) \
                + 0.1 * x
        elif name != "tok":
            x = x / np.sqrt(max(leaf.shape[-2], 1))
        return x.astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def pair(d_ff=None, dtype=None, seed=0):
    """Both configs, the reference's parameters and the port's model made
    from them (shared by the tests of one worker: neither side is
    mutated)."""
    over = {k: v for k, v in (("d_ff", d_ff), ("dtype", dtype))
            if v is not None}
    jcfg, tcfg = configs(**over)
    tree = ssm_params(jcfg, seed)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            model_params_from_jax(tcfg, tree, device="cpu"))


def close(jax_out, torch_out) -> float:
    return float(np.max(np.abs(np.asarray(jax_out, np.float32)
                               - torch_out.float().numpy())))


def test_the_model_has_the_references_mamba_leaves():
    jcfg, tcfg, params, model = pair()
    assert tcfg.family == "ssm" and len(model.layers) == 2
    assert all(layer.kind == "mamba" and not hasattr(layer, "attn")
               for layer in model.layers)
    names = {n.split(".", 1)[1] for n, _ in
             model.layers[0].ssm.named_parameters(prefix="ssm")}
    assert names == {"in_proj", "conv_w", "conv_b", "x_proj", "dt_w", "dt_b",
                     "a_log", "d_skip", "out_proj"}
    for g in range(2):
        for leaf in ("in_proj", "a_log", "d_skip"):
            want = np.asarray(params["layers"][0]["ssm"][leaf][g])
            got = getattr(model.layers[g].ssm, leaf).numpy()
            assert np.array_equal(got, want)
    # the port's own init: S4D-real a_log and d_skip of ones, in float32
    own = init_model(dataclasses.replace(tcfg, dtype="bfloat16"),
                     torch.Generator().manual_seed(0), device="cpu")
    want_a = np.asarray(jax_init_model(
        dataclasses.replace(jcfg, dtype="bfloat16"),
        jax.random.PRNGKey(0))["layers"][0]["ssm"]["a_log"][0])
    ssm = own.layers[0].ssm
    assert ssm.a_log.dtype == ssm.d_skip.dtype == torch.float32
    assert ssm.in_proj.dtype == torch.bfloat16
    assert np.allclose(ssm.a_log.numpy(), want_a, rtol=0, atol=1e-7)
    assert torch.equal(ssm.d_skip, torch.ones_like(ssm.d_skip))


@pytest.mark.parametrize("chunk", [16, 0])
def test_mamba_block_prefill_equals_the_reference(chunk):
    jcfg, tcfg, params, model = pair()
    lp = jax.tree.map(lambda a: a[1], params["layers"][0]["ssm"])
    x = np.random.default_rng(1).standard_normal((2, 40, tcfg.d_model),
                                                 dtype=np.float32)
    want = jax_ssm.mamba_forward(lp, jnp.asarray(x), jcfg.ssm, chunk=chunk)
    got = port_ssm.mamba_forward(model.layers[1].ssm, torch.from_numpy(x),
                                 tcfg.ssm)
    assert got.shape == (2, 40, tcfg.d_model)
    assert close(want, got) < TOL


def test_mamba_block_decode_steps_equal_the_reference():
    jcfg, tcfg, params, model = pair()
    lp = jax.tree.map(lambda a: a[0], params["layers"][0]["ssm"])
    xs = np.random.default_rng(2).standard_normal((6, 2, 1, tcfg.d_model),
                                                  dtype=np.float32)
    sj = jax_ssm.init_mamba_state(2, jcfg.d_model, jcfg.ssm, jnp.float32)
    st = port_ssm.init_mamba_state(2, tcfg.d_model, tcfg.ssm, torch.float32,
                                   "cpu")
    assert [tuple(t.shape) for t in st] == [tuple(a.shape) for a in sj]
    for x in xs:
        yj, sj = jax_ssm.mamba_decode_step(lp, jnp.asarray(x), sj, jcfg.ssm)
        yt, st = port_ssm.mamba_decode_step(model.layers[0].ssm,
                                            torch.from_numpy(x), st, tcfg.ssm)
        assert close(yj, yt) < TOL
        assert close(sj[0], st[0]) < TOL and close(sj[1], st[1]) < TOL


def test_the_block_goes_through_the_scan_wrapper(monkeypatch):
    jcfg, tcfg, params, model = pair()
    calls = []
    scan = ms.selective_scan

    def spy(*args, **kw):
        calls.append(tuple(t.shape for t in args))
        return scan(*args, **kw)

    monkeypatch.setattr(ms, "selective_scan", spy)
    x = torch.zeros((1, 5, tcfg.d_model))
    port_ssm.mamba_forward(model.layers[0].ssm, x, tcfg.ssm)
    di, N = 2 * tcfg.d_model, tcfg.ssm.d_state
    assert calls == [((1, 5, di), (1, 5, di), (1, 5, N), (1, 5, N), (di, N))]


def test_a_bfloat16_scan_is_not_ported():
    """The scan kernel's function is float32: on the kernel path a
    bfloat16 scan raises (the differentiable scan takes it, below)."""
    jcfg, tcfg, params, model = pair()
    x = torch.zeros((1, 5, tcfg.d_model))
    with pytest.raises(NotImplementedError, match="ssm_scan_dtype"):
        port_ssm.mamba_forward(model.layers[0].ssm, x, tcfg.ssm,
                               scan_impl="kernel", scan_dtype="bfloat16")


@pytest.mark.parametrize("S,chunk,scan_dtype", [
    (48, 16, "float32"), (40, 0, "float32"), (37, 16, "float32"),
    (48, 16, "bfloat16"), (40, 0, "bfloat16"), (37, 16, "bfloat16")],
    ids=["chunked", "unchunked", "padded", "chunked-bf16", "unchunked-bf16",
         "padded-bf16"])
def test_the_differentiable_scan_equals_the_reference(S, chunk, scan_dtype):
    """``scan_impl="chunked"`` against the reference's ``mamba_forward``
    with the same ``chunk`` and ``scan_dtype``: chunks of 16, one scan
    over the whole sequence (chunk 0), 37 steps padded to 48; and the
    chunked and unchunked scans agree with each other."""
    jcfg, tcfg, params, model = pair()
    lp = jax.tree.map(lambda a: a[1], params["layers"][0]["ssm"])
    x = np.random.default_rng(S).standard_normal((2, S, tcfg.d_model),
                                                 dtype=np.float32)
    want = jax_ssm.mamba_forward(lp, jnp.asarray(x), jcfg.ssm, chunk=chunk,
                                 scan_dtype=jnp.dtype(scan_dtype))
    run = functools.partial(port_ssm.mamba_forward, model.layers[1].ssm,
                            torch.from_numpy(x), tcfg.ssm,
                            scan_impl="chunked", scan_dtype=scan_dtype)
    got = run(chunk=chunk)
    assert got.shape == (2, S, tcfg.d_model)
    assert close(want, got) < TOL
    other = run(chunk=0 if chunk else 16)
    assert float((got - other).abs().max()) < TOL


def _prompt(cfg, B, S, seed):
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))
    return ({"tokens": jnp.asarray(tokens, jnp.int32)},
            {"tokens": torch.from_numpy(tokens)})


@pytest.mark.parametrize("d_ff", [None, 0], ids=["reduced", "d_ff0"])
@pytest.mark.parametrize("chunk", [16, 0], ids=["chunked", "unchunked"])
def test_prefill_equals_the_reference(d_ff, chunk):
    jcfg, tcfg, params, model = pair(d_ff)
    jcfg = dataclasses.replace(jcfg, scan_chunk=chunk)
    batch_j, batch_t = _prompt(tcfg, 2, 72, seed=3)
    want = jax_prefill_step(jcfg)(params, batch_j)
    got = make_prefill_step(tcfg)(model, batch_t)
    assert got.shape == (2, tcfg.vocab) and got.dtype == torch.float32
    assert close(want, got) < TOL


@pytest.mark.parametrize("d_ff", [None, 0], ids=["reduced", "d_ff0"])
def test_decode_from_an_empty_cache_equals_the_reference(d_ff):
    jcfg, tcfg, params, model = pair(d_ff)
    B, T = 2, 12
    toks = np.random.default_rng(4).integers(0, tcfg.vocab, (B, T))
    cj = jax_init_cache(jcfg, B, 16)
    ct = init_cache(tcfg, B, 16, device="cpu")
    di = 2 * tcfg.d_model
    assert ct["layers"][0]["conv"].shape == (B, di, tcfg.ssm.conv_dim - 1)
    assert ct["layers"][0]["h"].shape == (B, di, tcfg.ssm.d_state)
    assert ct["layers"][0]["h"].dtype == torch.float32
    step = make_serve_step(tcfg)
    jax_step = jax.jit(functools.partial(jax_decode, jcfg))
    for t in range(T):
        lj, cj = jax_step(params, cj, jnp.asarray(toks[:, t:t + 1],
                                                  jnp.int32))
        lt, ct = step(model, ct, torch.from_numpy(toks[:, t:t + 1]))
        assert close(lj, lt) < TOL, t
    assert ct["pos"] == T
    for i in range(2):
        assert close(cj["layers"][0]["h"][i], ct["layers"][i]["h"]) < TOL


def test_a_zero_width_ffn_draws_and_runs():
    """falcon-mamba's own d_ff = 0: the port's init draws an empty FFN
    (``w_down`` [0, d_model]) instead of dividing by its zero fan-in."""
    _, tcfg = configs(d_ff=0)
    model = init_model(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert tuple(model.layers[0].mlp.w_down.shape) == (0, tcfg.d_model)
    logits = make_prefill_step(tcfg)(model, {"tokens": torch.zeros(
        (1, 9), dtype=torch.long)})
    assert torch.isfinite(logits).all()


def test_bfloat16_conversion_keeps_a_log_and_d_skip_in_float32():
    jcfg, tcfg, params, model = pair(dtype="bfloat16")
    ssm = model.layers[0].ssm
    for leaf in ("a_log", "d_skip"):
        want = np.asarray(params["layers"][0]["ssm"][leaf][0])
        got = getattr(ssm, leaf)
        assert want.dtype == np.float32 and got.dtype == torch.float32
        assert np.array_equal(got.numpy(), want)
    for leaf in ("in_proj", "conv_w", "dt_b", "out_proj"):
        assert getattr(ssm, leaf).dtype == torch.bfloat16
    assert model.layers[0].ln1.w.dtype == torch.bfloat16
    # and the bf16 model runs: finite logits from a prefill
    _, batch_t = _prompt(tcfg, 1, 24, seed=5)
    assert torch.isfinite(make_prefill_step(tcfg)(model, batch_t)).all()
