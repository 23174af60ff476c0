"""The port's enc-dec family (seamless-m4t-large-v2) against the JAX
package's, on the CPU, with the reference's parameters carried across by
``model_params_from_jax``.

Reduced seamless (the reference's ``ModelConfig.reduced()``, float32: 2
encoder and 2 decoder layers, d_model 64, 4 heads of 16 over 2 kv heads,
LayerNorm, GELU MLP).  The reference runs its default attention, the
chunked online softmax; the port runs its plain paths: ``impl="flash"``
(the kernel's plain version on the CPU) and ``"direct"``.  Lengths are
multiples of the reduced 32-key chunk, where the reference's chunked path
pads no key into a non-causal softmax (``ROADMAP.md``, Queue 3).  Encoder
output, decoder hidden states, loss, the prefilled cache and 8 decode
steps are held to 1e-4 absolute: the same maths, summed in another
order."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.models import encdec as jax_ed  # noqa: E402
from repro.models import model_loss as jax_model_loss  # noqa: E402
from repro.train.step import \
    make_prefill_step as jax_prefill_step  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.convert import model_params_from_jax  # noqa: E402
from repro_torch.data.pipeline import make_batch  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models import encdec as ed  # noqa: E402
from repro_torch.models import (init_cache, init_model,  # noqa: E402
                                model_decode_step, model_forward,
                                model_loss)
from repro_torch.train.step import batch_to, make_prefill_step  # noqa: E402
from test_torch_models import jax_params  # noqa: E402

ARCH = "seamless-m4t-large-v2"
TOL = 1e-4


@functools.lru_cache(maxsize=None)
def pair(seed=0):
    jcfg, tcfg = JAX_ARCHS[ARCH].reduced(), ARCHS[ARCH].reduced()
    tree = jax_params(jcfg, seed)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            model_params_from_jax(tcfg, tree, device="cpu"))


def batches(cfg, s_src: int, s_tgt: int, seed: int):
    """Seeded frames [2, s_src, fd], tokens and labels [2, s_tgt], for both
    packages."""
    rng = np.random.default_rng(seed)
    b = {"frames": rng.standard_normal((2, s_src, cfg.frontend_dim),
                                       dtype=np.float32),
         "tokens": rng.integers(0, cfg.vocab, (2, s_tgt)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (2, s_tgt)).astype(np.int32)}
    return jax.tree.map(jnp.asarray, b), batch_to(b, "cpu")


def diff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - b.detach().numpy())))


def test_the_reference_config_is_reduced_as_described():
    jcfg, tcfg, _, model = pair()
    assert (tcfg.enc_layers, tcfg.n_layers, tcfg.n_heads, tcfg.n_kv_heads,
            tcfg.resolved_head_dim) == (2, 2, 4, 2, 16)
    assert tcfg.norm_type == "layernorm" and tcfg.mlp_type == "gelu"
    assert len(model.enc) == 2 and len(model.dec) == 2
    assert not hasattr(model.dec[0].cross, "bq")  # cross has no bias
    assert all(not p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("impl", ["flash", "direct"])
def test_encode_forward_and_loss_equal_the_reference(impl):
    jcfg, tcfg, params, model = pair()
    bj, bt = batches(tcfg, 320, 320, seed=1)
    want = jax_ed.encode(jcfg, params, bj["frames"])
    got = ed.encode(tcfg, model, bt["frames"], impl=impl)
    assert got.shape == (2, 320, tcfg.d_model) and diff(want, got) < TOL
    want = jax_ed.encdec_forward(jcfg, params, bj)
    got = model_forward(tcfg, model, bt, impl=impl)
    assert got.shape == (2, 320, tcfg.d_model) and diff(want, got) < TOL
    want = jax_model_loss(jcfg, params, bj)
    got = model_loss(tcfg, model, bt, impl=impl)
    assert abs(float(want) - float(got)) < TOL


def test_the_chunked_paths_agree_too():
    jcfg, tcfg, params, model = pair()
    bj, bt = batches(tcfg, 320, 320, seed=2)
    want = jax_ed.encdec_forward(jcfg, params, bj)
    assert diff(want, model_forward(tcfg, model, bt, impl="chunked")) < TOL
    assert diff(want, model_forward(tcfg, model, bt,
                                    impl="chunked2d")) < TOL


@pytest.mark.parametrize("s_src,s_tgt", [(288, 352), (96, 320), (352, 64)])
def test_source_and_target_lengths_may_differ(s_src, s_tgt):
    """Cross-attention at Sq != Skv: the chunked path (both products over
    256 x 256) and the direct path (one of them under it)."""
    jcfg, tcfg, params, model = pair()
    bj, bt = batches(tcfg, s_src, s_tgt, seed=3)
    want = jax_ed.encdec_forward(jcfg, params, bj)
    got = model_forward(tcfg, model, bt, impl="flash")
    assert got.shape == (2, s_tgt, tcfg.d_model) and diff(want, got) < TOL
    assert diff(jax_prefill_step(jcfg)(params, bj),
                make_prefill_step(tcfg, impl="flash")(model, bt)) < TOL


def test_the_split_decoder_pass_equals_encdec_forward():
    _, tcfg, _, model = pair()
    _, bt = batches(tcfg, 288, 320, seed=4)
    enc_out = ed.encode(tcfg, model, bt["frames"], impl="flash")
    split = ed.decode_hidden(tcfg, model, bt["tokens"], enc_out,
                             impl="flash")
    assert torch.equal(split, ed.encdec_forward(tcfg, model, bt,
                                                impl="flash"))


def test_prefill_cache_and_decode_equal_the_reference():
    """The cross K / V from one encoding, then 8 decode steps (the self
    cache filling from slot 0, cross-attention over the whole cross
    cache)."""
    jcfg, tcfg, params, model = pair()
    bj, bt = batches(tcfg, 96, 8, seed=5)
    B, max_len = 2, 16
    enc_j = jax_ed.encode(jcfg, params, bj["frames"])
    enc_t = ed.encode(tcfg, model, bt["frames"], impl="flash")
    cj = jax_ed.encdec_prefill_cache(jcfg, params, enc_j, B, max_len)
    ct = ed.encdec_prefill_cache(tcfg, model, enc_t, B, max_len)
    assert len(ct["layers"]) == tcfg.n_layers and ct["pos"] == 0
    for i, lc in enumerate(ct["layers"]):
        assert diff(cj["layers"]["cross_k"][i], lc["cross_k"]) < TOL
        assert diff(cj["layers"]["cross_v"][i], lc["cross_v"]) < TOL
        assert lc["k"].shape == (B, max_len, tcfg.n_kv_heads, 16)
    step = jax.jit(functools.partial(jax_ed.encdec_decode_step, jcfg))
    toks = np.array(bj["tokens"])
    for t in range(8):
        lj, cj = step(params, cj, jnp.asarray(toks[:, t:t + 1]))
        tok = torch.from_numpy(toks[:, t:t + 1]).long()
        with torch.no_grad():
            lt, ct = model_decode_step(tcfg, model, ct, tok)
        assert lt.shape == (B, tcfg.vocab) and diff(lj, lt) < TOL, t
    assert ct["pos"] == 8 == int(cj["pos"])
    with pytest.raises(IndexError, match="outside a cache"):
        for _ in range(max_len):  # past the self cache's end
            with torch.no_grad():
                _, ct = model_decode_step(
                    tcfg, model, ct, torch.zeros((B, 1), dtype=torch.long))


def test_the_pipelines_batch_and_an_empty_cache():
    """``make_batch``'s enc-dec batch (S_src = S_tgt = seq_len // 2) through
    both packages, and ``init_cache``'s empty cross cache (``enc_len``)."""
    jcfg, tcfg, params, model = pair()
    b = make_batch(tcfg, 2, 128, step=3)
    assert b["frames"].shape == (2, 64, tcfg.frontend_dim)
    want = jax_model_loss(jcfg, params, jax.tree.map(jnp.asarray, b))
    assert abs(float(want) - float(model_loss(tcfg, model,
                                              batch_to(b, "cpu")))) < TOL
    cache = init_cache(tcfg, 1, 8, enc_len=5, device="cpu")
    assert cache["layers"][0]["cross_k"].shape == (1, 5, tcfg.n_kv_heads, 16)
    assert cache["layers"][0]["k"].shape == (1, 8, tcfg.n_kv_heads, 16)


def test_the_ports_own_weights_are_seeded():
    _, tcfg, _, _ = pair()
    a = init_model(tcfg, torch.Generator().manual_seed(3), device="cpu")
    b = init_model(tcfg, torch.Generator().manual_seed(3), device="cpu")
    assert isinstance(a, ed.EncDec)
    for (na, pa), (nb, pb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert na == nb and torch.equal(pa, pb)


def _broken(tree, how: str):
    tree = jax.tree.map(lambda x: x, tree)  # a copy of the containers
    if how == "missing_leaf":
        del tree["dec"]["cross"]["wq"]
    elif how == "extra_leaf":
        tree["enc"]["attn"]["bq"] = np.zeros((2, 64), np.float32)
    elif how == "wrong_shape":
        tree["lm_head"] = np.zeros((64, 511), np.float32)
    elif how == "missing_stack":
        del tree["enc"]
    elif how == "short_stack":
        tree["dec"]["ln3"]["b"] = tree["dec"]["ln3"]["b"][:1]
    elif how == "layernorm_without_bias":
        del tree["enc_norm"]["b"]
    return tree


@pytest.mark.parametrize("how", ["missing_leaf", "extra_leaf", "wrong_shape",
                                 "missing_stack", "short_stack",
                                 "layernorm_without_bias"])
def test_the_carry_over_is_strict(how):
    jcfg, tcfg, _, _ = pair()
    tree = jax_params(jcfg, 0)
    with pytest.raises(ValueError, match="pytree does not"):
        model_params_from_jax(tcfg, _broken(tree, how), device="cpu")


def test_launch_serve_runs_seamless_on_the_cpu(capsys):
    """The reference launcher's arguments for enc-dec: a cross cache of
    length 0 (``init_cache``'s default ``enc_len``)."""
    port_serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "10",
                     "--sessions", "3", "--fail-cell-at", "4"])
    out = capsys.readouterr().out
    assert "10 decodes over 3 sessions" in out and "failing cell" in out
    assert "relocations=" in out
