"""The port's model stack against the JAX package's, on the CPU, with the
reference's parameters carried across by ``model_params_from_jax``.

Reduced configs (the reference's ``ModelConfig.reduced()``, float32):
gemma3-4b with 13 layers (two 6-layer periods and a 1-layer tail, window
16), starcoder2-15b (LayerNorm, GELU MLP, qkv bias), qwen1.5-32b with a
4-slot decode buffer, and internvl2-76b (the vision frontend).  Prefill at
S = 320 takes the flash path (320 * 320 > 256 * 256): the reference runs
its Pallas kernel in interpret mode, the port the kernel's plain version.
Then 20 decode steps from an empty cache (gemma's 16-slot ring wraps).
Logits are float32 and held to 1e-4 absolute: the same maths, summed in
another order."""
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
from repro.configs import param_counts as jax_param_counts  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import init_cache as jax_init_cache  # noqa: E402
from repro.models import init_model as jax_init_model  # noqa: E402
from repro.models import model_decode_step as jax_decode  # noqa: E402
from repro.models.transformer import merge_decode_buffer as jax_merge  # noqa: E402
from repro.train.step import make_prefill_step as jax_prefill_step  # noqa: E402
from repro_torch.configs import ARCHS, param_counts  # noqa: E402
from repro_torch.convert import model_params_from_jax  # noqa: E402
from repro_torch.models import (init_cache, init_model,  # noqa: E402
                                model_forward)
from repro_torch.models import attention as port_attn  # noqa: E402
from repro_torch.models.transformer import merge_decode_buffer  # noqa: E402
from repro_torch.train.step import (make_prefill_step,  # noqa: E402
                                    make_serve_step)

TOL = 1e-4

CASES = {
    "gemma3-4b": dict(n_layers=13),
    "starcoder2-15b": {},
    "qwen1.5-32b": dict(decode_buffer=4),
    "internvl2-76b": {},
}


def configs(arch):
    over = CASES[arch]
    return (dataclasses.replace(JAX_ARCHS[arch].reduced(), **over),
            dataclasses.replace(ARCHS[arch].reduced(), **over))


def jax_params(jcfg, seed: int):
    """The reference's parameter pytree for ``jcfg`` (its structure from
    ``init_model``, traced, not run), filled from a numpy seed: weights
    N(0, 1/fan_in), embeddings N(0, 1), norm gains near 1 and biases near
    0 — non-trivial everywhere, so every leaf's conversion shows."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(functools.partial(jax_init_model, jcfg),
                            jax.random.PRNGKey(0))

    def draw(path, leaf):
        name = getattr(path[-1], "key", "")
        x = rng.standard_normal(leaf.shape, dtype=np.float32)
        if name == "w":
            x = 1.0 + 0.1 * x
        elif name.startswith("b"):
            x = 0.1 * x
        elif name != "tok":
            x = x / np.sqrt(leaf.shape[-2])
        return x.astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def pair(arch, seed=0):
    """Both configs, the reference's parameters and the port's model made
    from them (shared by the tests of one worker: neither side is
    mutated)."""
    jcfg, tcfg = configs(arch)
    tree = jax_params(jcfg, seed)
    params = jax.tree.map(jnp.asarray, tree)
    return jcfg, tcfg, params, model_params_from_jax(tcfg, tree, device="cpu")


def close(jax_logits, torch_logits) -> float:
    return float(np.max(np.abs(np.asarray(jax_logits)
                               - torch_logits.numpy())))


def test_configs_are_the_reference_configs():
    assert sorted(ARCHS) == sorted(JAX_ARCHS)
    for name, cfg in ARCHS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(JAX_ARCHS[name])
        assert dataclasses.asdict(cfg.reduced()) == \
            dataclasses.asdict(JAX_ARCHS[name].reduced())
        assert param_counts(cfg) == jax_param_counts(JAX_ARCHS[name])


def test_conversion_lays_the_scan_stacks_out_flat():
    jcfg, tcfg, params, model = pair("gemma3-4b")
    assert tcfg.period == 6 and tcfg.n_tail == 1 and len(model.layers) == 13
    assert [layer.kind for layer in model.layers] == \
        ["local"] * 5 + ["attn"] + ["local"] * 5 + ["attn"] + ["local"]
    for i, (g, p) in enumerate([(0, 0), (0, 5), (1, 3)]):
        layer = model.layers[g * 6 + p]
        want = np.asarray(params["layers"][p]["attn"]["wq"][g])
        assert np.array_equal(layer.attn.wq.numpy(), want)
    assert np.array_equal(model.layers[12].mlp.w_down.numpy(),
                          np.asarray(params["tail"][0]["mlp"]["w_down"]))
    assert np.array_equal(model.final_norm.w.numpy(),
                          np.asarray(params["final_norm"]["w"]))
    assert not hasattr(model, "lm_head")  # tied embeddings
    assert all(not p.requires_grad for p in model.parameters())


def _prompt(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    batch_j = {"tokens": jnp.asarray(tokens)}
    batch_t = {"tokens": torch.from_numpy(tokens).long()}
    if cfg.frontend == "vision":
        patches = rng.standard_normal((B, cfg.n_patches, cfg.frontend_dim),
                                      dtype=np.float32)
        batch_j["patches"] = jnp.asarray(patches)
        batch_t["patches"] = torch.from_numpy(patches)
    return batch_j, batch_t


@pytest.mark.parametrize("arch", sorted(CASES))
def test_prefill_on_the_flash_path_equals_the_reference(arch):
    jcfg, tcfg, params, model = pair(arch)
    batch_j, batch_t = _prompt(tcfg, 1, 320, seed=1)
    want = jax_prefill_step(jcfg, impl="flash")(params, batch_j)
    got = make_prefill_step(tcfg, impl="flash")(model, batch_t)
    assert got.shape == (1, tcfg.vocab) and got.dtype == torch.float32
    assert close(want, got) < TOL


@pytest.mark.parametrize("impl", ["direct", "chunked", "chunked2d"])
def test_prefill_on_the_other_paths_equals_the_reference(impl):
    jcfg, tcfg, params, model = pair("starcoder2-15b")
    batch_j, batch_t = _prompt(tcfg, 2, 288, seed=2)
    want = jax_prefill_step(jcfg, impl=impl)(params, batch_j)
    got = make_prefill_step(tcfg, impl=impl)(model, batch_t)
    assert close(want, got) < TOL
    hidden = model_forward(tcfg, model, batch_t, impl=impl)
    assert hidden.shape == (2, 288, tcfg.d_model)


@pytest.mark.parametrize("arch", ["gemma3-4b", "starcoder2-15b",
                                  "qwen1.5-32b"])
def test_decode_from_an_empty_cache_equals_the_reference(arch):
    jcfg, tcfg, params, model = pair(arch)
    B, T, max_len = 2, 20, 32
    toks = np.random.default_rng(3).integers(0, tcfg.vocab, (B, T))
    cj = jax_init_cache(jcfg, B, max_len)
    ct = init_cache(tcfg, B, max_len, device="cpu")
    step = make_serve_step(tcfg)
    jax_step = jax.jit(functools.partial(jax_decode, jcfg))
    for t in range(T):
        lj, cj = jax_step(params, cj,
                          jnp.asarray(toks[:, t:t + 1], jnp.int32))
        lt, ct = step(model, ct, torch.from_numpy(toks[:, t:t + 1]))
        assert close(lj, lt) < TOL, t
        if tcfg.decode_buffer and (t + 1) % tcfg.decode_buffer == 0:
            cj = jax_merge(jcfg, cj)
            ct = merge_decode_buffer(tcfg, ct)
    assert ct["pos"] == T
    if tcfg.decode_buffer:
        assert ct["cache_len"] == T == int(cj["cache_len"])


def test_decode_pieces_equal_the_reference():
    """Ring positions, cache writes and both decode attentions, one step
    past the ring's wrap."""
    rng = np.random.default_rng(4)
    B, H, K, hd, W, L, BUF = 2, 4, 2, 16, 8, 12, 4
    q = rng.standard_normal((B, 1, H, hd), dtype=np.float32)
    kc = rng.standard_normal((B, L, K, hd), dtype=np.float32)
    vc = rng.standard_normal((B, L, K, hd), dtype=np.float32)
    kb = rng.standard_normal((B, BUF, K, hd), dtype=np.float32)
    vb = rng.standard_normal((B, BUF, K, hd), dtype=np.float32)
    new = rng.standard_normal((B, 1, K, hd), dtype=np.float32)
    T = torch.from_numpy
    for pos in (0, 5, 11):
        assert np.array_equal(
            np.asarray(jax_attn.ring_slot_positions(jnp.int32(pos), W)),
            port_attn.ring_slot_positions(pos, W).numpy())
    slot_j = jax_attn.ring_slot_positions(jnp.int32(9), W)
    kj, vj = jax_attn.ring_insert(jnp.asarray(kc[:, :W]),
                                  jnp.asarray(vc[:, :W]), jnp.asarray(new),
                                  jnp.asarray(new), jnp.int32(9), W)
    kt, vt = port_attn.ring_insert(T(kc[:, :W].copy()), T(vc[:, :W].copy()),
                                   T(new), T(new), 9, W)
    assert np.array_equal(np.asarray(kj), kt.numpy())
    want = jax_attn.decode_attention(jnp.asarray(q), kj, vj, jnp.int32(9),
                                     slot_pos=slot_j)
    got = port_attn.decode_attention(T(q), kt, vt, 9,
                                     slot_pos=port_attn.ring_slot_positions(
                                         9, W))
    assert close(want, got) < 1e-5
    kj, vj = jax_attn.cache_insert(jnp.asarray(kc), jnp.asarray(vc),
                                   jnp.asarray(new), jnp.asarray(new),
                                   jnp.int32(6))
    kt, vt = port_attn.cache_insert(T(kc.copy()), T(vc.copy()), T(new),
                                    T(new), 6)
    assert np.array_equal(np.asarray(vj), vt.numpy())
    assert close(jax_attn.decode_attention(jnp.asarray(q), kj, vj,
                                           jnp.int32(6)),
                 port_attn.decode_attention(T(q), kt, vt, 6)) < 1e-5
    assert close(
        jax_attn.decode_attention_buffered(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
            jnp.asarray(kb), jnp.asarray(vb), jnp.int32(8), jnp.int32(10)),
        port_attn.decode_attention_buffered(T(q), T(kc), T(vc), T(kb),
                                            T(vb), 8, 10)) < 1e-5
    with pytest.raises(IndexError, match="outside a cache"):
        port_attn.cache_insert(kt, vt, T(new), T(new), L)


def test_the_ports_own_weights_are_seeded_and_finite():
    """``init_model`` draws from the generator it is given, on the CPU when
    asked; the same seed gives the same weights and a finite forward."""
    cfg = dataclasses.replace(ARCHS["gemma3-4b"].reduced(), n_layers=7)
    a = init_model(cfg, torch.Generator().manual_seed(5), device="cpu")
    b = init_model(cfg, torch.Generator().manual_seed(5), device="cpu")
    for (na, pa), (nb, pb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert na == nb and torch.equal(pa, pb)
    tokens = torch.arange(40).reshape(1, 40) % cfg.vocab
    logits = make_prefill_step(cfg, impl="flash")(a, {"tokens": tokens})
    assert logits.shape == (1, cfg.vocab) and torch.isfinite(logits).all()
