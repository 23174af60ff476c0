"""The port's MoE FFN and the moe and hybrid families against the JAX
package's, on the CPU, float32.

``moe_ffn`` alone, held to 1e-5 absolute (one FFN: the same float32 maths,
summed in another order): swiglu and gelu experts, a group whose experts
overflow their capacity (the order of the k choices decides who is
dropped), router probabilities tied across experts (the lower index must
win, as ``jax.lax.top_k`` orders them), a token count that is not a
multiple of ``group_size`` (the zero-padded last group), and one token
(decode: ``g = 1``).  Then the conversion of a bfloat16 MoE model, which
keeps the reference's float32 router, and the reduced qwen3-moe-30b-a3b,
arctic-480b (MoE with its dense residual) and jamba-1.5-large-398b
(attention and mamba layers, dense and MoE FFNs in one stack), with the
reference's parameters carried across by ``model_params_from_jax``: the
prefill at S = 320 on the flash path (the reference's Pallas kernel in
interpret mode, the port's kernel's plain version) and 20 decode steps from
an empty cache, logits held to 1e-4 absolute, as ``test_torch_models.py``
holds the dense families.
"""
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
from repro.configs import MoESpec as JaxMoESpec  # noqa: E402
from repro.models import init_cache as jax_init_cache  # noqa: E402
from repro.models import model_decode_step as jax_decode  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.train.step import make_prefill_step as jax_prefill_step  # noqa: E402
from repro_torch.configs import ARCHS, MoESpec  # noqa: E402
from repro_torch.convert import model_params_from_jax  # noqa: E402
from repro_torch.models import init_cache, init_model  # noqa: E402
from repro_torch.models import moe as port_moe  # noqa: E402
from repro_torch.train.step import (make_prefill_step,  # noqa: E402
                                    make_serve_step)

from test_torch_ssm import ssm_params  # noqa: E402

FFN_TOL = 1e-5
TOL = 1e-4
ARCHS_MOE = ("qwen3-moe-30b-a3b", "arctic-480b", "jamba-1.5-large-398b")


def close(jax_out, torch_out) -> float:
    return float(np.max(np.abs(np.asarray(jax_out, np.float32)
                               - torch_out.float().numpy())))


# --------------------------------------------------------------------------- #
# moe_ffn alone
# --------------------------------------------------------------------------- #

D, FF = 32, 16


def ffn_params(E: int, mlp_type: str, seed: int, *, tie=0, bias=0.0):
    """A MoE layer's leaves as numpy float32: router N(0, 1/D), with
    ``tie``: its first ``tie`` columns equal and the others their negation
    (every token's best ``tie`` or ``E - tie`` experts tie), and ``bias``
    added to column 0 (an expert most tokens prefer or avoid strongly);
    experts N(0, 1/fan_in)."""
    rng = np.random.default_rng(seed)
    router = rng.standard_normal((D, E), dtype=np.float32) / np.sqrt(D)
    if tie:
        router[:, 1:tie] = router[:, :1]
        router[:, tie:] = -router[:, :1]
    router[:, 0] += bias
    p = {"router": router,
         "w_up": rng.standard_normal((E, D, FF), dtype=np.float32)
         / np.sqrt(D),
         "w_down": rng.standard_normal((E, FF, D), dtype=np.float32)
         / np.sqrt(FF)}
    if mlp_type == "swiglu":
        p["w_gate"] = rng.standard_normal((E, D, FF), dtype=np.float32) \
            / np.sqrt(D)
    return {k: v.astype(np.float32) for k, v in p.items()}


def port_layer(p, spec, mlp_type):
    m = port_moe.MoE(D, spec, torch.float32, mlp_type, generator=None,
                     device="meta")
    for name, arr in p.items():
        setattr(m, name, torch.nn.Parameter(torch.from_numpy(arr.copy()),
                                            requires_grad=False))
    return m


def routing(p, x, spec):
    """The reference's routing of ``x`` in numpy: per group, each token's
    top-k experts (stable: lower index first among ties), and the most
    choices any expert got in any group."""
    B, S, _ = x.shape
    N = B * S
    g = min(spec.group_size, N)
    xf = np.concatenate([x.reshape(N, D),
                         np.zeros(((-N) % g, D), np.float32)])
    logits = xf.reshape(-1, g, D) @ p["router"]
    top = np.argsort(-logits, axis=-1, kind="stable")[..., :spec.top_k]
    per_expert = max(int(np.bincount(grp.ravel(),
                                     minlength=spec.n_experts).max())
                     for grp in top)
    return top, per_expert


#: name: (E, top_k, group_size, capacity_factor, (B, S), mlp_type, tie,
#: bias)
FFN_CASES = {
    "swiglu": (8, 2, 16, 1.25, (2, 40), "swiglu", 0, 0.0),
    "gelu": (8, 2, 16, 1.25, (2, 40), "gelu", 0, 0.0),
    "overflow": (8, 2, 64, 0.25, (1, 64), "swiglu", 0, 2.0),
    "tied": (8, 2, 16, 1.25, (2, 24), "gelu", 4, 0.0),
    "ragged_group": (4, 2, 16, 1.25, (1, 45), "swiglu", 0, 0.0),
    "one_token": (8, 2, 512, 1.25, (1, 1), "swiglu", 0, 0.0),
}


@pytest.mark.parametrize("case", sorted(FFN_CASES))
def test_moe_ffn_equals_the_reference(case):
    E, k, gs, cf, (B, S), mlp_type, tie, bias = FFN_CASES[case]
    kw = dict(n_experts=E, top_k=k, d_ff_expert=FF, capacity_factor=cf,
              group_size=gs)
    jspec, tspec = JaxMoESpec(**kw), MoESpec(**kw)
    p = ffn_params(E, mlp_type, seed=len(case), tie=tie, bias=bias)
    x = np.random.default_rng(7).standard_normal((B, S, D),
                                                 dtype=np.float32)
    want = jax_moe.moe_ffn(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                           jspec, mlp_type)
    got = port_moe.moe_ffn(port_layer(p, tspec, mlp_type),
                           torch.from_numpy(x), tspec, mlp_type)
    assert got.shape == (B, S, D) and got.dtype == torch.float32
    assert close(want, got) < FFN_TOL
    g = min(gs, B * S)
    cap = port_moe._capacity(tspec, g)
    assert cap == jax_moe._capacity(jspec, g)
    top, most = routing(p, x, tspec)
    if case == "overflow":  # some expert was chosen past its capacity
        assert most > cap
    elif case == "tied":  # four equal best experts: the two lowest win
        low = (top == [0, 1]).all(-1)
        assert (low | (top == [4, 5]).all(-1)).all()
        assert low.any() and not low.all()
    elif case == "ragged_group":
        assert (B * S) % gs and cap == 12
    elif case == "one_token":
        assert g == 1 and cap == 4


def test_capacity_rounds_as_the_reference():
    for E, k, cf, n in ((128, 8, 1.25, 512), (128, 8, 1.25, 1),
                        (16, 2, 1.25, 512), (128, 2, 1.25, 512),
                        (7, 3, 0.9, 33)):
        kw = dict(n_experts=E, top_k=k, d_ff_expert=4, capacity_factor=cf)
        assert port_moe._capacity(MoESpec(**kw), n) == \
            jax_moe._capacity(JaxMoESpec(**kw), n)
    qwen = ARCHS["qwen3-moe-30b-a3b"].moe
    assert port_moe._capacity(qwen, 512) == 40  # prefill groups
    assert port_moe._capacity(qwen, 1) == 8  # decode: top_k, rounded to 4


# --------------------------------------------------------------------------- #
# the moe and hybrid families
# --------------------------------------------------------------------------- #


def configs(arch, **over):
    return (dataclasses.replace(JAX_ARCHS[arch].reduced(), **over),
            dataclasses.replace(ARCHS[arch].reduced(), **over))


@functools.lru_cache(maxsize=None)
def pair(arch, dtype=None, seed=0):
    """Both configs, the reference's parameters (every leaf drawn from a
    numpy seed, :func:`test_torch_ssm.ssm_params`) and the port's model
    made from them (shared by the tests of one worker: neither side is
    mutated)."""
    over = {} if dtype is None else {"dtype": dtype}
    jcfg, tcfg = configs(arch, **over)
    tree = ssm_params(jcfg, seed)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            model_params_from_jax(tcfg, tree, device="cpu"))


def test_the_layers_hold_the_references_ffns():
    for arch, kinds, ffns in (
            ("qwen3-moe-30b-a3b", ["attn"] * 2, ["moe"] * 2),
            ("arctic-480b", ["attn"] * 2, ["moe+dense"] * 2),
            ("jamba-1.5-large-398b",
             (["attn"] + ["mamba"] * 7) * 2, ["dense", "moe"] * 8)):
        _, tcfg, params, model = pair(arch)
        assert [layer.kind for layer in model.layers] == kinds
        assert [layer.ffn_kind for layer in model.layers] == ffns
        for i, layer in enumerate(model.layers):
            assert hasattr(layer, "mlp") == (layer.ffn_kind != "moe")
            assert hasattr(layer, "moe") == (layer.ffn_kind != "dense")
            if hasattr(layer, "moe"):
                g, p = divmod(i, tcfg.period)
                want = np.asarray(params["layers"][p]["moe"]["w_down"][g])
                assert np.array_equal(layer.moe.w_down.numpy(), want)


def test_bfloat16_conversion_keeps_the_router_in_float32():
    jcfg, tcfg, params, model = pair("qwen3-moe-30b-a3b", dtype="bfloat16")
    moe = model.layers[1].moe
    want = np.asarray(params["layers"][0]["moe"]["router"][1])
    assert want.dtype == np.float32 and moe.router.dtype == torch.float32
    assert np.array_equal(moe.router.numpy(), want)
    for leaf in ("w_gate", "w_up", "w_down"):
        assert getattr(moe, leaf).dtype == torch.bfloat16
    # the port's own init draws the router in float32 too, and runs
    own = init_model(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert own.layers[0].moe.router.dtype == torch.float32
    assert own.layers[0].moe.w_up.dtype == torch.bfloat16
    tokens = torch.arange(24).reshape(1, 24) % tcfg.vocab
    for m in (model, own):
        logits = make_prefill_step(tcfg)(m, {"tokens": tokens})
        assert torch.isfinite(logits).all()


def test_a_tree_without_the_moe_leaves_is_refused():
    jcfg, tcfg = configs("qwen3-moe-30b-a3b")
    tree = ssm_params(jcfg, 0)
    del tree["layers"][0]["moe"]["router"]
    with pytest.raises(ValueError, match="missing.*router"):
        model_params_from_jax(tcfg, tree, device="cpu")


def _prompt(cfg, B, S, seed):
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))
    return ({"tokens": jnp.asarray(tokens, jnp.int32)},
            {"tokens": torch.from_numpy(tokens)})


@pytest.mark.parametrize("arch", ARCHS_MOE)
def test_prefill_on_the_flash_path_equals_the_reference(arch):
    jcfg, tcfg, params, model = pair(arch)
    batch_j, batch_t = _prompt(tcfg, 1, 320, seed=1)
    want = jax_prefill_step(jcfg, impl="flash")(params, batch_j)
    got = make_prefill_step(tcfg, impl="flash")(model, batch_t)
    assert got.shape == (1, tcfg.vocab) and got.dtype == torch.float32
    assert close(want, got) < TOL


@pytest.mark.parametrize("arch", ARCHS_MOE)
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
    assert ct["pos"] == T
    if tcfg.family == "hybrid":  # attention and mamba caches in one model
        kinds = [sorted(lc) for lc in ct["layers"]]
        assert kinds[0] == ["k", "v"] and kinds[1] == ["conv", "h"]
        assert close(cj["layers"][1]["h"][0], ct["layers"][1]["h"]) < TOL
