"""Jamba (AI21-Jamba2-Mini's layout) on the port against the benchmark's
plain float32 reference (``bench/reference/jamba.py``), on seeded random
weights at small widths (``bench/tests/small_jamba.py``), on the CPU.

The stack: two periods of eight layers in the published order (attention
at period position 4, experts on odd layers).  The prefill's last logits,
on both SSM paths, and then the prompt decoded token by token through the
port's cache from empty and 4 more tokens, each step's logits against the
reference's whole forward pass: float32 on both sides, so within 1e-4 of
max(1, max |logit|).  The dropless MoE against a plain loop over tokens
and their choices (1e-5: the same float32 maths summed in another order),
with an exact tie between a token's 2nd and 3rd experts (the lower index
wins), over one row of tokens and over a batch.  Every existing
configuration, with the new fields at their defaults, takes the earlier
paths bit for bit.  The ``model.moe`` span records only under the
profiler.

Marked ``cuda`` (skipped without a card): the reduced model in bfloat16
against the same model on the kernels' plain versions, each layer (fed the
plain path's input) within one bfloat16 ulp of its max |output|; the
grouped expert products at the published widths against the float32
products; and an MoE layer that makes no host synchronisation.
"""
import dataclasses
import functools
import math
import os

import pytest

torch = pytest.importorskip("torch")
# torch's intra-op threads: this pytest-xdist worker's share of the cores
torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", 1))))

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from bench.entries.prefill import load_model, port_config  # noqa: E402
from bench.harness.weights import Weights  # noqa: E402
from bench.reference import jamba as ref  # noqa: E402
from bench.tests import small_jamba  # noqa: E402
from repro_torch.configs import ARCHS, ModelConfig, MoESpec  # noqa: E402
from repro_torch.models import init_cache, init_model  # noqa: E402
from repro_torch.models import moe as port_moe  # noqa: E402
from repro_torch.models import ssm as port_ssm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.obs import spans  # noqa: E402
from repro_torch.train.step import (make_prefill_step,  # noqa: E402
                                    make_serve_step)

TOL = 1e-4
FFN_TOL = 1e-5
CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def small(seed: int = 0, dtype: str = "float32"):
    """(reference config, port config, weights, port model)."""
    cfg = small_jamba.config(dtype)
    pcfg = port_config(cfg)
    w = Weights(ref.leaves(cfg), seed=seed, device=CPU)
    return cfg, pcfg, w, load_model(pcfg, w)


def _tokens(cfg, S, seed):
    return torch.randint(0, cfg["vocab_size"], (S,),
                         generator=torch.Generator().manual_seed(seed))


def _close(got, want):
    return torch.allclose(got, want, rtol=0.0,
                          atol=TOL * max(1.0, float(want.abs().max())))


# --------------------------------------------------------------------------- #
# the stack
# --------------------------------------------------------------------------- #


def test_two_periods_in_the_published_order():
    cfg, pcfg, _, model = small()
    assert pcfg.n_layers == 16 and pcfg.period == 8
    kinds = [layer.kind for layer in model.layers]
    assert kinds == (["mamba"] * 4 + ["attn"] + ["mamba"] * 3) * 2
    assert [layer.ffn_kind for layer in model.layers] == ["dense", "moe"] * 8
    assert kinds == ["attn" if ref.is_attention(cfg, i) else "mamba"
                     for i in range(16)]
    assert [layer.ffn_kind == "moe" for layer in model.layers] == [
        ref.has_experts(cfg, i) for i in range(16)]
    # the cache holds both kinds of state, by the same layer kinds
    cache = init_cache(pcfg, 1, 8, device="cpu")
    assert [sorted(lc) for lc in cache["layers"]] == [
        ["k", "v"] if k == "attn" else ["conv", "h"] for k in kinds]


@pytest.mark.parametrize("scan_impl", ["kernel", "chunked"])
@pytest.mark.parametrize("S", [1, 37, 300])
def test_prefill_matches_the_reference(S, scan_impl):
    cfg, pcfg, w, model = small()
    tokens = _tokens(cfg, S, S)
    got = make_prefill_step(pcfg, impl="flash", scan_impl=scan_impl)(
        model, {"tokens": tokens[None]})[0]
    assert _close(got, ref.last_logits(cfg, w, tokens))


def test_prefill_then_four_decodes_match_the_reference():
    """The prompt decoded one token at a time from an empty cache ends at
    the prefill's logits; each of 4 further steps matches the reference's
    forward pass over the whole sequence so far."""
    cfg, pcfg, w, model = small(seed=1)
    S, extra = 12, 4
    tokens = _tokens(cfg, S + extra, 5)
    prefill = make_prefill_step(pcfg, impl="flash")(
        model, {"tokens": tokens[None, :S]})[0]
    assert _close(prefill, ref.last_logits(cfg, w, tokens[:S]))
    step = make_serve_step(pcfg)
    cache = init_cache(pcfg, 1, S + extra, device="cpu")
    for t in range(S + extra):
        logits, cache = step(model, cache, tokens[None, t:t + 1])
        if t == S - 1:
            assert _close(logits[0], prefill)
        if t >= S - 1:
            assert _close(logits[0], ref.last_logits(cfg, w, tokens[:t + 1]))


# --------------------------------------------------------------------------- #
# the dropless MoE
# --------------------------------------------------------------------------- #


def _moe(E=4, D=16, ff=8, seed=0, tie=False, bias=0.0):
    spec = MoESpec(n_experts=E, top_k=2, d_ff_expert=ff,
                   dispatch="dropless")
    m = port_moe.MoE(D, spec, torch.float32, "swiglu",
                     generator=torch.Generator().manual_seed(seed),
                     device="cpu")
    with torch.no_grad():
        if tie:  # for tokens of positive entries: experts 1 and 2 equal,
            # 0 ahead of them and 3 behind
            m.router[:, 2] = m.router[:, 1]
            m.router[:, 0] = m.router[:, 1] + 0.5
            m.router[:, 3] = m.router[:, 1] - 0.5
        m.router[:, 0] += bias  # for such tokens, expert 0 ahead
    return m, spec


def _plain(m, x, spec, renorm=False):
    """Token by token, choice by choice: a float32 softmax over every
    expert, its two largest (the lower index first), each expert's SwiGLU
    on the token, weighted by the softmax (divided by the two's sum under
    ``renorm``, as GShard weighs them)."""
    out = torch.zeros_like(x)
    for t in range(x.shape[0]):
        p = torch.softmax(x[t].float() @ m.router, -1)
        order = sorted(range(p.shape[0]), key=lambda e: (-float(p[e]), e))
        top = order[:spec.top_k]
        w = p[top] / p[top].sum() if renorm else p[top]
        for e, we in zip(top, w):
            h = torch.nn.functional.silu(x[t] @ m.w_gate[e]) \
                * (x[t] @ m.w_up[e])
            out[t] += we * (h @ m.w_down[e])
    return out


@pytest.mark.parametrize("shape", [(1, 40), (4, 10)])
@pytest.mark.parametrize("case", ["random", "tie", "skewed"])
def test_dropless_moe_matches_the_plain_expert_loop(case, shape):
    m, spec = _moe(tie=case == "tie", bias=3.0 if case == "skewed" else 0.0)
    x = torch.randn((*shape, 16), generator=torch.Generator().manual_seed(3))
    if case != "random":  # tokens of positive entries (``_moe``)
        x = x.abs()
    got = port_moe.moe_ffn(m, x, spec, "swiglu").reshape(40, 16)
    x = x.reshape(40, 16)
    assert torch.allclose(got, _plain(m, x, spec), rtol=0, atol=FFN_TOL)
    top_p, top_i = port_moe.route_dropless(m, x, spec)
    probs = torch.softmax(x @ m.router, -1)  # the weights as it gives them
    assert torch.equal(top_p, probs.gather(1, top_i))
    if case == "tie":  # the 2nd and 3rd tie exactly: the lower index
        assert torch.equal(probs[:, 1], probs[:, 2])
        assert top_i[:, 0].eq(0).all() and top_i[:, 1].eq(1).all()
    if case == "skewed":  # expert 0 takes every token; none is dropped
        assert top_i[:, 0].eq(0).all()


def test_gshard_stays_the_default_and_drops_past_capacity():
    """The registry's MoE configurations keep GShard, which drops a
    choice past an expert's capacity; the dropless dispatch of the same
    layer serves it."""
    assert all(c.moe is None or c.moe.dispatch == "gshard"
               for c in ARCHS.values())
    m, spec = _moe(bias=3.0)
    spec = dataclasses.replace(spec, group_size=40)
    x = torch.randn((1, 40, 16),
                    generator=torch.Generator().manual_seed(3)).abs()
    dropless = port_moe.moe_ffn(m, x, spec, "swiglu")
    gshard = port_moe.moe_ffn(m, x, dataclasses.replace(
        spec, dispatch="gshard"), "swiglu")
    assert torch.allclose(dropless[0], _plain(m, x[0], spec), atol=FFN_TOL)
    assert not torch.allclose(gshard[0], _plain(m, x[0], spec, renorm=True),
                              atol=FFN_TOL)
    with pytest.raises(ValueError, match="dispatch"):
        port_moe.moe_ffn(m, x, dataclasses.replace(spec, dispatch="x"),
                         "swiglu")


# --------------------------------------------------------------------------- #
# the earlier paths at the new fields' defaults
# --------------------------------------------------------------------------- #


def _earlier_layer_kind(self, p):
    if self.family == "ssm":
        return "mamba"
    if self.attn_every is not None:
        return "attn" if p == 0 else "mamba"
    if self.local_global_period is not None:
        n_local, _ = self.local_global_period
        return "local" if p < n_local else "attn"
    return "attn"


def _earlier_rotate(cfg, kind, q, k, positions):
    theta = tf._rope_theta(cfg, kind)
    return (tf.apply_rope(q, positions, theta),
            tf.apply_rope(k, positions, theta))


def _run(cfg, model, tokens):
    from repro_torch.models import model_forward

    batch = {"tokens": tokens}
    if cfg.frontend == "vision":
        batch["patches"] = torch.randn(
            (1, cfg.n_patches, cfg.frontend_dim),
            generator=torch.Generator().manual_seed(4))
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(
            (1, 16, cfg.frontend_dim),
            generator=torch.Generator().manual_seed(4))
        return model_forward(cfg, model, batch)
    logits = make_prefill_step(cfg, impl="flash")(model, batch)
    cache = init_cache(cfg, 1, 4, device="cpu")
    step, _ = make_serve_step(cfg)(model, cache, tokens[:, :1])
    return logits, step


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_existing_configurations_take_the_earlier_paths(arch, monkeypatch):
    """Each registry configuration (reduced), its new fields at their
    defaults: the same parameters as before (no inner norms) and, bit for
    bit, the same prefill and decode logits as with the layer order, the
    RoPE and the SSM block's inputs as they were before the fields."""
    cfg = ARCHS[arch].reduced()
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert not any(n.endswith(("dt_norm", "b_norm", "c_norm"))
                   for n, _ in model.named_parameters())
    tokens = torch.randint(0, cfg.vocab, (1, 24),
                           generator=torch.Generator().manual_seed(1))
    now = _run(cfg, model, tokens)
    monkeypatch.setattr(ModelConfig, "layer_kind", _earlier_layer_kind)
    monkeypatch.setattr(tf, "_rotate", _earlier_rotate)
    monkeypatch.setattr(port_ssm, "_inner_norms",
                        lambda m, spec, dt, b, c: (dt, b, c))
    before = _run(cfg, model, tokens)
    if cfg.family == "encdec":
        now, before = (now,), (before,)
    assert all(torch.equal(a, b) for a, b in zip(now, before))


# --------------------------------------------------------------------------- #
# the span
# --------------------------------------------------------------------------- #


@pytest.fixture
def empty_ring():
    spans.clear()
    yield
    spans.clear()


def test_moe_spans_only_under_the_profiler(empty_ring):
    cfg, pcfg, _, model = small()
    step = make_prefill_step(pcfg, impl="flash")
    batch = {"tokens": _tokens(cfg, 30, 2)[None]}
    off = step(model, batch)
    assert spans.records() == []
    with profile(activities=[ProfilerActivity.CPU]):
        on = step(model, batch)
        step(model, batch)
    assert torch.equal(off, on)
    moe_spans = [r for r in spans.records() if r[0] == "model.moe"]
    assert len(moe_spans) == 2 * 8
    layers = [r for r in spans.records() if r[0] == "model.layer"]
    assert all(any(lay[1] <= m[1] and m[2] <= lay[2] for lay in layers)
               for m in moe_spans)


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")


def _card_config():
    """The small layout at widths the card's kernels take: head dim 64 with
    four query heads a kv head, as published, and widths the grouped
    products align to."""
    cfg = small_jamba.config("bfloat16")
    cfg.update(hidden_size=256, num_key_value_heads=1, intermediate_size=128)
    cfg["port"]["replace"].update(d_model=256, n_kv_heads=1, head_dim=64,
                                  d_ff=128)
    cfg["port"]["replace"]["moe"].update(d_ff_expert=128)
    return cfg


def _plain_paths(mp):
    """Every kernel of the prefill on its plain version."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms

    mp.setattr(fa, "flash_attention", fa.flash_attention_ref)
    mp.setattr(ms, "selective_scan_fused", functools.partial(
        ms.selective_scan_fused, backend="ref"))
    mp.setattr(ms, "causal_conv_silu", functools.partial(
        ms.causal_conv_silu, backend="ref"))
    mp.setattr(port_moe, "expert_products", port_moe.expert_loop)


def _ulp(top: float) -> float:
    """One bfloat16 ulp at ``top``."""
    return 2.0 ** (math.floor(math.log2(top)) - 7)


@pytest.mark.cuda
def test_a_reduced_jamba_prefill_on_the_card_matches_its_plain_paths(card):
    """The kernels of the prefill, launched as often as the layout says
    (bf16 flash in the 2 attention layers, the conv and the scan's second
    entry in the 14 Mamba layers), and each layer, fed the plain path's
    input, against the same layer with every kernel on its plain version
    (the grouped expert products on the loop): within one bfloat16 ulp of
    the layer's max |output|."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms

    cfg = _card_config()
    pcfg = port_config(cfg)
    w = Weights(ref.leaves(cfg), seed=7, device=torch.device("cuda"))
    model = load_model(pcfg, w)
    tokens = _tokens(cfg, 300, 8).cuda()[None]
    step = make_prefill_step(pcfg, impl="flash")
    before = [k.launches for k in (*fa.KERNELS, *ms.KERNELS)]
    got = step(model, {"tokens": tokens})
    torch.cuda.synchronize()
    after = [k.launches for k in (*fa.KERNELS, *ms.KERNELS)]
    # f32 flash, bf16 flash, first scan entry, second entry, conv
    assert [a - b for a, b in zip(after, before)] == [0, 2, 0, 14, 14]
    assert bool(torch.isfinite(got).all())
    real, inputs = tf._apply_layer, []

    def record(c, layer, x, *a):
        inputs.append((layer, x, a))
        return real(c, layer, x, *a)

    with pytest.MonkeyPatch.context() as mp:
        _plain_paths(mp)
        mp.setattr(tf, "_apply_layer", record)
        plain = step(model, {"tokens": tokens})
    assert len(inputs) == 16
    worst = []
    with torch.no_grad():
        for layer, x, a in inputs:
            out = real(pcfg, layer, x, *a)
            with pytest.MonkeyPatch.context() as mp:
                _plain_paths(mp)
                want = real(pcfg, layer, x, *a)
            worst.append(float((out - want).abs().max())
                         / _ulp(float(want.abs().max())))
    print(f"layers, kernels against plain versions, in ulps of max |out|: "
          f"{worst}; logits {float((got - plain).abs().max())} of max "
          f"{float(plain.abs().max())}", flush=True)
    assert max(worst) <= 1.0


@pytest.mark.cuda
def test_grouped_expert_products_at_published_widths_on_the_card(card):
    """(D, ff) = (4096, 14336) over 16 experts, one of them given no row:
    each grouped product within its float32 product's bf16 rounding (and
    the float32 sums' reordering)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(9)
    E, D, F = 16, 4096, 14336
    counts = torch.randint(0, 400, (E,), generator=g, device="cuda")
    counts[5] = 0
    ends = torch.cumsum(counts, 0)
    R = int(ends[-1])
    rows = torch.randn((R, D), generator=g, device="cuda").bfloat16()
    for w in (torch.randn((E, D, F), generator=g, device="cuda"),
              torch.randn((E, F, D), generator=g, device="cuda")):
        w = (w * w.shape[1] ** -0.5).bfloat16()
        x = rows if w.shape[1] == D else torch.randn(
            (R, F), generator=g, device="cuda").bfloat16()
        got = port_moe.expert_products(x, ends, w).float()
        want = port_moe.expert_loop(x.float(), ends, w.float())
        scale = port_moe.expert_loop(x.float().abs(), ends, w.float().abs())
        assert bool((got - want).abs().le(
            2.0 ** -8 * want.abs() + 2.0 ** -20 * scale).all())
        loop = port_moe.expert_loop(x, ends, w).float()
        assert bool((loop - want).abs().le(
            2.0 ** -8 * want.abs() + 2.0 ** -20 * scale).all())


@pytest.mark.cuda
def test_an_moe_layer_makes_no_host_synchronisation_on_the_card(card):
    cfg = _card_config()
    pcfg = port_config(cfg)
    model = load_model(pcfg, Weights(ref.leaves(cfg), seed=3,
                                     device=torch.device("cuda")))
    layer = model.layers[1]
    x = torch.randn((1, 500, pcfg.d_model), device="cuda").bfloat16()
    with torch.no_grad():
        want = tf._apply_ffn(pcfg, layer, x)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = tf._apply_ffn(pcfg, layer, x)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, want)
