"""The port's roofline tooling against the reference's, on the CPU.

``repro_torch.roofline.hlo`` and ``flops.analyze`` are copies of the
reference's text parsers: on HLO text that JAX compiles here (a loop-free
program, scans, nested scans) and on partitioned HLO text with every kind
of collective, they give the reference's numbers exactly, mirroring
``tests/test_roofline.py``.  The aten-stream counter (``OpCounter``) gives
XLA's ``cost_analysis()`` flops exactly on a products-only function, and
the per-op rules by hand on a small one.  ``RooflineOracle`` matches the
reference's on ``test_analysis.py``'s cases and on compiled HLO, and
prices a PyTorch call (``add_module``) from the counter.
"""
import os

import pytest

torch = pytest.importorskip("torch")
# torch's intra-op threads: this pytest-xdist worker's share of the cores
torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", 1))))

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.analysis import RooflineOracle as RefOracle  # noqa: E402
from repro.roofline import flops as ref_flops  # noqa: E402
from repro.roofline import hlo as ref_hlo  # noqa: E402
from repro_torch.analysis import RooflineOracle, TableOracle  # noqa: E402
from repro_torch.roofline import flops, hlo  # noqa: E402


def compiled(fn, *structs):
    c = jax.jit(fn).lower(*structs).compile()
    ca = c.cost_analysis()
    if isinstance(ca, list):  # older jax returns [dict], newer returns dict
        ca = ca[0]
    return c.as_text(), ca


def f32(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


def _loop_free(x, w):
    return jnp.tanh(x @ w).sum()


def _scan(x, w):
    def body(c, wi):
        return c @ wi, None
    y, _ = jax.lax.scan(body, x, w)
    return y


def _nested(x):
    def inner(c, _):
        return c * 2.0, None

    def outer(c, _):
        c, _ = jax.lax.scan(inner, c, None, length=3)
        return c, None

    y, _ = jax.lax.scan(outer, x, None, length=5)
    return y


PROGRAMS = {"loop_free": (_loop_free, (f32(128, 256), f32(256, 512))),
            "scan": (_scan, (f32(128, 128), f32(6, 128, 128))),
            "nested": (_nested, (f32(8),))}

# partitioned HLO as GSPMD prints it: collectives of each kind and both
# replica-group forms, an async pair, a loop of 4 trips around two of them
COLLECTIVE_HLO = """
HloModule sharded

%body (p: (s32[], f32[8,64])) -> (s32[], f32[8,64]) {
  %p = (s32[], f32[8,64]) parameter(0)
  %i = s32[] get-tuple-element(%p), index=0
  %x = f32[8,64] get-tuple-element(%p), index=1
  %ar = f32[8,64] all-reduce(%x), replica_groups=[2,4]<=[8], to_apply=%add
  %ag = bf16[8,256] all-gather(%ar), replica_groups={{0,1,2,3},{4,5,6,7}}, dimensions={1}
  %one = s32[] constant(1)
  %j = s32[] add(%i, %one)
  ROOT %t = (s32[], f32[8,64]) tuple(%j, %ar)
}

%cond (p: (s32[], f32[8,64])) -> pred[] {
  %p = (s32[], f32[8,64]) parameter(0)
  %i = s32[] get-tuple-element(%p), index=0
  %n = s32[] constant(4)
  ROOT %lt = pred[] compare(%i, %n), direction=LT
}

%add (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %s = f32[] add(%a, %b)
}

ENTRY %main (x: f32[8,64]) -> f32[2,64] {
  %x = f32[8,64] parameter(0)
  %zero = s32[] constant(0)
  %t0 = (s32[], f32[8,64]) tuple(%zero, %x)
  %w = (s32[], f32[8,64]) while(%t0), condition=%cond, body=%body
  %y = f32[8,64] get-tuple-element(%w), index=1
  %rs = f32[2,64] reduce-scatter(%y), replica_groups=[2,4]<=[8], dimensions={0}, to_apply=%add
  %a2a = f32[2,64] all-to-all(%rs), replica_groups={{0,1},{2,3},{4,5},{6,7}}, dimensions={0}
  %ags = (f32[2,64], f32[8,64]) all-gather-start(%a2a), replica_groups=[2,4]<=[8], dimensions={0}
  %agd = f32[8,64] all-gather-done(%ags)
  ROOT %cp = f32[2,64] collective-permute(%a2a), source_target_pairs={{0,1},{1,0}}
}
"""


@pytest.mark.parametrize("s", ["bf16[2,1024]", "f32[]", "pred[7]",
                               "s32[3,3]{1,0}", "f8e4m3fn[4,4]", "u4[9]",
                               "c128[2]", "token[]", "f64[0,5]"])
def test_shape_bytes_equals_the_reference(s):
    assert hlo.shape_bytes(s) == ref_hlo.shape_bytes(s)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_analyze_equals_the_reference_on_compiled_hlo(name):
    fn, structs = PROGRAMS[name]
    text, ca = compiled(fn, *structs)
    assert flops.analyze(text) == ref_flops.analyze(text)
    assert hlo.computation_multiplicities(text) == \
        ref_hlo.computation_multiplicities(text)
    got = flops.analyze(text)
    if name == "loop_free":  # the reference's own check against XLA
        assert abs(got["flops"] - ca["flops"]) / ca["flops"] < 0.05
        assert abs(got["bytes"] - ca["bytes accessed"]) \
            / ca["bytes accessed"] < 0.05
    elif name == "scan":  # six trips of the body, which XLA counts once
        assert abs(got["flops"] - 6 * 2 * 128 ** 3) / (6 * 2 * 128 ** 3) \
            < 0.01
        assert ca["flops"] < 6 * 2 * 128 ** 3 / 2
    else:  # the inner body runs 5 x 3 times
        assert max(hlo.computation_multiplicities(text).values()) >= 15


@pytest.mark.parametrize("loop_aware", [True, False], ids=["loop", "flat"])
def test_collective_summary_equals_the_reference(loop_aware):
    got = hlo.collective_summary(COLLECTIVE_HLO, loop_aware=loop_aware)
    assert got == ref_hlo.collective_summary(COLLECTIVE_HLO,
                                             loop_aware=loop_aware)
    assert set(got) == {"all-reduce", "all-gather", "reduce-scatter",
                        "all-to-all", "collective-permute"}
    assert got["all-reduce"]["count"] == (4.0 if loop_aware else 1.0)
    # all-reduce over groups of 4: 2 B (s - 1) / s a trip
    assert got["all-reduce"]["link_bytes"] == \
        got["all-reduce"]["count"] * 2 * 8 * 64 * 4 * 3 / 4
    assert hlo.total_link_bytes(COLLECTIVE_HLO, loop_aware=loop_aware) == \
        ref_hlo.total_link_bytes(COLLECTIVE_HLO, loop_aware=loop_aware)
    assert [(o.kind, o.result_bytes, o.group_size, o.link_bytes)
            for o in hlo.parse_collectives(COLLECTIVE_HLO)] == \
        [(o.kind, o.result_bytes, o.group_size, o.link_bytes)
         for o in ref_hlo.parse_collectives(COLLECTIVE_HLO)]
    assert flops.analyze(COLLECTIVE_HLO) == ref_flops.analyze(COLLECTIVE_HLO)


# --------------------------------------------------------------------------- #
# the aten-stream counter
# --------------------------------------------------------------------------- #


def einsum(eq):
    """``eq`` by ``jnp.einsum`` on JAX arrays and ``torch.einsum`` on
    tensors."""
    return lambda a, b: (torch if isinstance(a, torch.Tensor)
                         else jnp).einsum(eq, a, b)


PRODUCTS = {
    "mm": (lambda a, b: a @ b, [(40, 16), (16, 8)]),
    "batched_by_2d": (lambda x, w: x @ w, [(4, 16, 32), (32, 24)]),
    "bmm": (lambda x, v: x @ v, [(4, 16, 24), (4, 24, 8)]),
    "gqa_einsum": (einsum("bqkh,bskh->bkqs"), [(3, 5, 2, 8), (3, 7, 2, 8)]),
    "moe_dispatch": (einsum("gnec,gnd->gecd"), [(2, 6, 3, 4), (2, 6, 5)]),
}


@pytest.mark.parametrize("name", sorted(PRODUCTS))
def test_the_counters_product_flops_equal_xla_exactly(name):
    """A products-only function (a plain product, a batched one, a
    GQA-style einsum, MoE's dispatch einsum): the counter's flops are XLA's
    ``cost_analysis()["flops"]`` for the same jnp function, to the flop."""
    fn, shapes = PRODUCTS[name]
    arrs = [np.random.default_rng(i).standard_normal(s, dtype=np.float32)
            for i, s in enumerate(shapes)]
    _, ca = compiled(fn, *(f32(*s) for s in shapes))
    _, counts = flops.count(fn, *(torch.from_numpy(a) for a in arrs))
    assert counts["product_flops"] == counts["flops"] == ca["flops"] > 0


def test_the_counter_applies_the_per_op_rules():
    """Elementwise and transcendental ops prod(result), a reduction
    prod(operand), bytes the operands and the result of each executed op;
    views and factory ops count nothing; on meta tensors as on real ones."""
    def fn(x, w):
        y = torch.tanh(x @ w)  # product, then one transcendental
        z = y.reshape(-1).view(8, 32) + 1.0  # two views, one add
        return z.sum(dim=-1), torch.zeros(5)  # a reduction, a factory

    for dev in ("cpu", "meta"):
        x, w = torch.ones(16, 8, device=dev), torch.ones(8, 16, device=dev)
        _, c = flops.count(fn, x, w)
        assert c["product_flops"] == 2 * 16 * 16 * 8
        assert c["flops"] == 2 * 16 * 16 * 8 + 256 + 256 + 256
        assert c["bytes"] == 4 * ((128 + 128 + 256) + (256 + 256)
                                  + (256 + 256) + (256 + 8))


def test_the_counter_keeps_collectives_apart():
    from repro_torch.roofline.hlo import CollectiveOp

    assert flops.collective_link_bytes("all-reduce", 1000, 4) == \
        CollectiveOp("all-reduce", 1000, 4, "").link_bytes == 1500.0
    assert flops.collective_link_bytes("all-gather", 1000, 1) == 0.0


# --------------------------------------------------------------------------- #
# the counter's live bytes
# --------------------------------------------------------------------------- #

N = 1000  # float32 elements: 4000 bytes a tensor


@pytest.mark.parametrize("dev", ["cpu", "meta"])
def test_the_counter_keeps_a_chains_peak_in_closed_form(dev):
    """x held; a = 2x, b = a + 1, a freed, c = exp(b), s = sum(c): at most
    x, a and b (or x, b, c and the 4-byte s) live at once, 3 x 4000 + 4
    bytes; at the end x, b, c and s."""
    x = torch.ones(N, device=dev)
    with flops.OpCounter(hold=x) as c:
        a = x * 2
        b = a + 1
        assert c.live_bytes == 3 * 4 * N
        del a  # a freed intermediate is subtracted
        assert c.live_bytes == 2 * 4 * N
        e = b.exp()
        s = e.sum()
        live = c.live_bytes
    assert live == 3 * 4 * N + 4
    assert c.peak_bytes == 3 * 4 * N + 4
    assert c.memory((b, e, s)) == {
        "argument_bytes": 4 * N, "output_bytes": 2 * 4 * N + 4,
        "temp_bytes": 0, "peak_bytes": 3 * 4 * N + 4, "alias_bytes": 0}


@pytest.mark.parametrize("dev", ["cpu", "meta"])
def test_views_and_in_place_ops_add_nothing(dev):
    """Views, in-place ops and an ``out=`` result into a held tensor reuse
    a held storage: the peak stays the arguments'; the in-place writes
    show as aliased bytes."""
    x, y = torch.ones(8, N // 8, device=dev), torch.ones(N, device=dev)
    with flops.OpCounter(hold=(x, y)) as c:
        v = x.view(-1)[::2].unsqueeze(0)
        x.t().mul_(2.0)
        x.add_(1.0)
        torch.add(v.reshape(-1)[:1], 1.0, out=y[:1])
    assert c.peak_bytes == c.live_bytes == 2 * 4 * N
    assert c.memory(v) == {"argument_bytes": 2 * 4 * N, "output_bytes": 0,
                           "temp_bytes": 0, "peak_bytes": 2 * 4 * N,
                           "alias_bytes": 2 * 4 * N}


@pytest.mark.parametrize("dev", ["cpu", "meta"])
def test_a_backwards_saved_tensors_count_until_it_frees_them(dev):
    """y = 2x, z = sin(y), s = sum(z): sin saves y, so dropping the names y
    and z leaves y live until the backward runs; the backward holds at most
    x, y, s, its seed, cos(y) and y's gradient (4 x 4000 + 8 bytes), and
    leaves x, its gradient and s."""
    x = torch.ones(N, device=dev, requires_grad=True)
    with flops.OpCounter(hold=x) as c:
        y = x * 2
        z = y.sin()
        s = z.sum()
        assert c.live_bytes == 3 * 4 * N + 4
        del y, z
        assert c.live_bytes == 2 * 4 * N + 4
        s.backward()
        live = c.live_bytes
    assert live == 2 * 4 * N + 4 and x.grad is not None
    assert c.peak_bytes == 4 * 4 * N + 8


def _reduced(arch: str, remat: str = "none"):
    import dataclasses

    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch(arch).reduced(), remat=remat)


def _step_args(cfg, kind: str, dev: str):
    """One step's function and arguments on ``dev``: the reduced model
    (seeded on the CPU, its shapes alone on ``meta``), AdamW's state and a
    batch for a train step, a batch for a prefill, an empty cache and a
    token for a decode step."""
    from repro_torch.models import init_model, params_shape
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    from repro_torch.train.step import (make_prefill_step, make_serve_step,
                                        make_train_step)

    model = params_shape(cfg) if dev == "meta" else init_model(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    ids = torch.zeros((2, 32), dtype=torch.int64, device=dev)
    if kind == "train":
        ocfg = adamw.AdamWConfig()
        opt = adamw.init(ocfg, dict(model.named_parameters()))
        return make_train_step(cfg, ocfg), (model, opt, {
            "tokens": ids, "labels": ids.clone()})
    if kind == "prefill":
        return make_prefill_step(cfg, scan_impl="chunked"), (
            model, {"tokens": ids})
    return make_serve_step(cfg), (model, tf.init_cache(cfg, 2, 32,
                                                       device=dev), ids[:, :1])


STEPS = [("train", "gemma3-4b", "none"), ("train", "gemma3-4b", "full"),
         ("train", "falcon-mamba-7b", "none"),
         ("train", "falcon-mamba-7b", "full"),
         ("prefill", "gemma3-4b", "none"), ("prefill", "falcon-mamba-7b",
                                            "none"),
         ("decode", "gemma3-4b", "none"), ("decode", "falcon-mamba-7b",
                                           "none")]


@pytest.mark.parametrize("kind,arch,remat", STEPS,
                         ids=["-".join(s) for s in STEPS])
def test_meta_counts_the_memory_of_real_tensors(kind, arch, remat):
    """One reduced step on ``meta`` counts the same memory, byte for byte,
    as on real CPU tensors: a train step writes its parameters and moments
    in place and returns its metrics and step count, a prefill returns its
    logits, a decode step its logits and new cache entries."""
    cfg = _reduced(arch, remat)
    got = {}
    for dev in ("cpu", "meta"):
        step, args = _step_args(cfg, kind, dev)
        with flops.OpCounter(hold=args) as c:
            out = step(*args)
        got[dev] = c.memory(out)
    assert got["meta"] == got["cpu"]
    mem = got["cpu"]
    assert mem["peak_bytes"] > mem["argument_bytes"] > 0
    assert mem["output_bytes"] > 0
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["output_bytes"] \
        + mem["temp_bytes"]
    model = args[0]
    params = sum(p.numel() * p.element_size() for p in model.parameters())
    if kind == "train":  # the parameters and both float32 moments
        assert mem["alias_bytes"] == params + 2 * 4 * sum(
            p.numel() for p in model.parameters())
    elif kind == "decode":  # a KV cache is written in place; the mamba
        # states are replaced by new tensors
        assert mem["alias_bytes"] <= mem["argument_bytes"] - params
        assert (mem["alias_bytes"] > 0) == (cfg.family != "ssm")
    else:
        assert mem["alias_bytes"] == 0


@pytest.mark.parametrize("arch,remat", [("gemma3-4b", "none"),
                                        ("falcon-mamba-7b", "full")])
def test_chip_smokes_meta_count_holds_what_a_real_step_holds(arch, remat):
    """``chip_smoke.train_step_counted``, to which the card's measured
    peak is held, counts on ``meta`` what the counter gives a real CPU
    step of the same configuration and batch: memory, flops and bytes."""
    import chip_smoke
    from repro_torch.optim import adamw

    cfg = _reduced(arch, remat)
    step, args = _step_args(cfg, "train", "cpu")
    with flops.OpCounter(hold=args) as c:
        out = step(*args)
    got = chip_smoke.train_step_counted(cfg, adamw.AdamWConfig(), args[2])
    assert got["memory"] == c.memory(out)
    assert got["counts"] == c.counts()


# --------------------------------------------------------------------------- #
# the oracle
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("cls", [RooflineOracle, RefOracle],
                         ids=["port", "reference"])
def test_roofline_oracle_takes_the_binding_term(cls):
    """``test_analysis.py``'s cases, on both packages."""
    o = cls(peak_flops_s=100.0, peak_bytes_s=10.0, table={"tiny": 0.25})
    assert o.add_counts("fn", flops=1000.0, bytes_=10.0) == \
        pytest.approx(10.0)  # compute-bound
    assert o.service_s("fn") == pytest.approx(10.0)
    o.add_counts("io", flops=10.0, bytes_=1000.0)  # memory-bound: 100s
    assert o.service_s("io") == pytest.approx(100.0)
    assert o.service_s("tiny") == 0.25  # table fallback
    assert o.service_s("ghost") is None
    with pytest.raises(ValueError, match="positive"):
        cls(peak_flops_s=0.0, peak_bytes_s=1.0)


def test_roofline_oracle_equals_the_reference_on_hlo_and_prices_a_module():
    fn, structs = PROGRAMS["scan"]
    text, _ = compiled(fn, *structs)
    peaks = dict(peak_flops_s=989e12, peak_bytes_s=3.35e12)
    port, ref = RooflineOracle(**peaks), RefOracle(**peaks)
    assert port.add_hlo("scan", text) == ref.add_hlo("scan", text)
    assert port.service_s("scan") == ref.service_s("scan")
    # a PyTorch call, counted op by op on meta tensors (nothing runs)
    x, w = (torch.empty(s, device="meta") for s in ((256, 512), (512, 512)))
    s = port.add_module("mm", torch.matmul, x, w)
    assert s == port.service_s("mm") == max(
        2 * 256 * 512 * 512 / 989e12,
        4 * (2 * 256 * 512 + 512 * 512) / 3.35e12)
    assert TableOracle({"x": 1.0}).service_s("x") == 1.0
