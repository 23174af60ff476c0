"""The port's training path against the JAX package's, on the CPU: the train
step, AdamW, gradient compression, checkpoints, the data pipeline and the
training driver.

The first seven tests mirror ``tests/test_train_and_checkpoint.py`` on the
port (reduced gemma3-4b, float32).  Then one train step on both packages
from the same parameters (the reference's, carried across) and batch, for
reduced gemma3-4b, qwen3-moe-30b-a3b, internvl2-76b, seamless-m4t,
falcon-mamba-7b and jamba-1.5-large-398b (the mamba layers through the
differentiable chunked scan, 6 chunks of 16 steps):
loss and grad norm within 1e-5 relative, each parameter's gradient within
1e-4 of that leaf's largest |g| (the same maths under two autodiffs, summed
in another order).  ``adamw.update`` and ``GradCompressor.apply`` are held
to the reference apart from autograd, on the same numpy inputs, within
1e-6 relative: a step-1 AdamW update is about lr x sign(g), so a gradient
near 0 that flips sign between two autodiffs would move a parameter by
2 lr, and updated parameters are not compared after autograd."""
import ast
import dataclasses
import functools
import os
import shutil
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# torch's intra-op threads: this pytest-xdist worker's share of the cores
torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", 1))))

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.models import model_loss as jax_model_loss  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.optim.compress import GradCompressor as JaxCompressor  # noqa: E402
from repro.train.step import make_train_step as jax_train_step  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.convert import (flatten_jax_params,  # noqa: E402
                                 model_params_from_jax)
from repro_torch.data.pipeline import (DataConfig, SyntheticLM,  # noqa: E402
                                       make_batch)
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models import init_model, model_loss  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.compress import GradCompressor  # noqa: E402
from repro_torch.train.step import batch_to, make_train_step  # noqa: E402
from test_torch_models import jax_params  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
REL = 1e-5
GRAD_TOL = 1e-4
OPT_REL = 1e-6


def tiny_cfg(**over):
    return dataclasses.replace(ARCHS["gemma3-4b"].reduced(), remat="none",
                               **over)


def fresh(cfg, seed=0):
    return init_model(cfg, torch.Generator().manual_seed(seed), device="cpu")


def opt_init(ocfg, model):
    return adamw.init(ocfg, dict(model.named_parameters()))


def batch(cfg, B, S, step, seed=0):
    return batch_to(make_batch(cfg, B, S, step, seed=seed), "cpu")


def snapshot(model):
    return {k: p.detach().clone() for k, p in model.named_parameters()}


# --------------------------------------------------------------------------- #
# tests/test_train_and_checkpoint.py on the port
# --------------------------------------------------------------------------- #


def test_loss_decreases():
    cfg = tiny_cfg()
    ocfg = adamw.AdamWConfig(lr=2e-3, warmup_steps=5, total_steps=40)
    model = fresh(cfg)
    opt = opt_init(ocfg, model)
    step = make_train_step(cfg, ocfg)
    losses = []
    for i in range(40):
        model, opt, m = step(model, opt, batch(cfg, 8, 64, i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.8, (losses[0], losses[-1])
    assert all(not p.requires_grad for p in model.parameters())


def test_checkpoint_restart_bit_identical():
    cfg = tiny_cfg()
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    step = make_train_step(cfg, ocfg)

    # uninterrupted run: 10 steps
    model = fresh(cfg)
    opt = opt_init(ocfg, model)
    for i in range(10):
        model, opt, m = step(model, opt, batch(cfg, 4, 32, i))
    ref_loss, ref_params = float(m["loss"]), snapshot(model)

    # interrupted run: 5 steps, checkpoint, 'crash', rebuild, restore, 5 more
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        m2 = fresh(cfg)
        o2 = opt_init(ocfg, m2)
        for i in range(5):
            m2, o2, _ = step(m2, o2, batch(cfg, 4, 32, i))
        mgr.save(5, port_train.train_state(m2, o2))
        del m2, o2
        m3 = fresh(cfg, seed=9)  # other weights, overwritten by the restore
        o3 = opt_init(ocfg, m3)
        o3 = port_train.load_train_state(
            m3, mgr.restore(port_train.train_state(m3, o3)))
        assert int(o3["step"]) == 5
        for i in range(5, 10):
            m3, o3, m = step(m3, o3, batch(cfg, 4, 32, i))
    assert float(m["loss"]) == ref_loss
    for k, p in m3.named_parameters():
        assert torch.equal(p, ref_params[k]), k


def test_checkpoint_async_and_gc():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2)
        tree = {"a": torch.arange(10.0),
                "b": {"c": torch.ones((3, 3), dtype=torch.bfloat16) / 3},
                "s": torch.tensor(7, dtype=torch.int32)}
        for s in (1, 2, 3):
            mgr.save(s, tree, blocking=(s == 3))
        mgr.wait()
        assert mgr.steps() == [2, 3]  # gc kept the last 2
        out = mgr.restore(tree, step=3)
        assert torch.equal(out["a"], torch.arange(10.0))
        assert out["b"]["c"].dtype == torch.bfloat16
        assert torch.equal(out["b"]["c"], tree["b"]["c"])
        assert out["s"].dtype == torch.int32 and int(out["s"]) == 7


def test_checkpoint_restore_shape_mismatch_raises():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(1, {"a": torch.zeros((4,))})
        with pytest.raises(ValueError):
            mgr.restore({"a": torch.zeros((5,))})
        with pytest.raises(KeyError):
            mgr.restore({"b": torch.zeros((4,))})


def test_grad_compression_parity():
    """int8 grads + error feedback track the uncompressed run closely."""
    cfg = tiny_cfg()
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=30)

    def run(compress):
        comp = GradCompressor() if compress else None
        model = fresh(cfg)
        opt = opt_init(ocfg, model)
        if comp:
            opt["compress"] = comp.init(dict(model.named_parameters()))
        step = make_train_step(cfg, ocfg, compressor=comp)
        losses = []
        for i in range(25):
            model, opt, m = step(model, opt, batch(cfg, 4, 32, i))
            losses.append(float(m["loss"]))
        return losses

    base = run(False)
    comp = run(True)
    assert comp[-1] < base[0]  # it trains
    assert abs(comp[-1] - base[-1]) / base[-1] < 0.15  # and tracks closely


def test_data_pipeline_deterministic_and_resumable():
    lm = SyntheticLM(DataConfig(vocab=100, batch=4, seq_len=16, seed=3))
    a = lm.batch_at(7)
    b = SyntheticLM(DataConfig(vocab=100, batch=4, seq_len=16,
                               seed=3)).batch_at(7)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert a["tokens"].shape == (4, 16)
    # labels are next-token shifted
    np.testing.assert_array_equal(a["labels"][:, :-1], a["tokens"][:, 1:])


def test_microbatch_grad_accumulation_matches():
    cfg = tiny_cfg()
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                             clip_norm=None)
    b = batch(cfg, 8, 32, 0)
    m1, m2 = fresh(cfg), fresh(cfg)
    m1, _, r1 = make_train_step(cfg, ocfg)(m1, opt_init(ocfg, m1), b)
    m2, _, r2 = make_train_step(cfg, ocfg, microbatches=2)(
        m2, opt_init(ocfg, m2), b)
    assert abs(float(r1["loss"]) - float(r2["loss"])) < 1e-4
    p2 = dict(m2.named_parameters())
    assert max(float((p - p2[k]).abs().max())
               for k, p in m1.named_parameters()) < 1e-4


# --------------------------------------------------------------------------- #
# one train step on both packages
# --------------------------------------------------------------------------- #

STEP_ARCHS = ("gemma3-4b", "qwen3-moe-30b-a3b", "internvl2-76b",
              "seamless-m4t-large-v2", "falcon-mamba-7b",
              "jamba-1.5-large-398b")


@functools.lru_cache(maxsize=None)
def step_pair(arch):
    """Both configs (reduced, float32, no remat), the reference's
    parameters as numpy, and a batch of ``make_batch`` (B = 2, 96
    positions; seamless: 48 frames and 48 target tokens)."""
    jcfg = dataclasses.replace(JAX_ARCHS[arch].reduced(), remat="none")
    tcfg = dataclasses.replace(ARCHS[arch].reduced(), remat="none")
    S = 96 + (tcfg.n_patches if tcfg.frontend == "vision" else 0)
    return jcfg, tcfg, jax_params(jcfg, seed=1), make_batch(tcfg, 2, S, 0)


def port_grads(tcfg, model, b):
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    loss = model_loss(tcfg, model, batch_to(b, "cpu"), scan_impl="chunked")
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_one_train_step_equals_the_reference(arch):
    jcfg, tcfg, tree, b = step_pair(arch)
    params = jax.tree.map(jnp.asarray, tree)
    bj = jax.tree.map(jnp.asarray, b)
    ocfg = adamw.AdamWConfig()
    jocfg = jax_adamw.AdamWConfig()
    _, _, jm = jax.jit(jax_train_step(jcfg, jocfg))(
        params, jax_adamw.init(jocfg, params), bj)
    model = model_params_from_jax(tcfg, tree, device="cpu")
    model, _, tm = make_train_step(tcfg, ocfg)(
        model, opt_init(ocfg, model), batch_to(b, "cpu"))
    for key in ("loss", "grad_norm", "lr"):
        want, got = float(jm[key]), float(tm[key])
        assert abs(got - want) <= REL * abs(want), (key, want, got)

    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_model_loss(jcfg, p, bj))(params)
    want = flatten_jax_params(tcfg, jax.tree.map(np.asarray, jgrads))
    loss, got = port_grads(tcfg, model_params_from_jax(tcfg, tree,
                                                       device="cpu"), b)
    assert abs(loss - float(jloss)) <= REL * abs(float(jloss))
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        top = float(np.abs(want[k]).max())
        err = float(np.abs(g.numpy() - want[k]).max())
        assert err <= GRAD_TOL * top, (k, err, top)


def test_remat_gives_the_same_step():
    """``remat="full"`` (each layer under ``torch.utils.checkpoint``) gives
    the same loss and parameters as no remat, bit for bit, on the dense,
    the enc-dec and the mamba stacks."""
    for arch in ("gemma3-4b", "seamless-m4t-large-v2", "falcon-mamba-7b"):
        _, tcfg, tree, b = step_pair(arch)
        ocfg = adamw.AdamWConfig()
        out = []
        for remat in ("none", "full"):
            cfg = dataclasses.replace(tcfg, remat=remat)
            model = model_params_from_jax(cfg, tree, device="cpu")
            model, _, m = make_train_step(cfg, ocfg)(
                model, opt_init(ocfg, model), batch_to(b, "cpu"))
            out.append((float(m["loss"]), snapshot(model)))
        assert out[0][0] == out[1][0]
        for k, p in out[0][1].items():
            assert torch.equal(p, out[1][1][k]), (arch, k)


# --------------------------------------------------------------------------- #
# AdamW and the compressor on the same inputs
# --------------------------------------------------------------------------- #

SHAPES = {"embed": (40, 16), "w": (16, 24), "bias": (24,), "scalar": ()}


def leaves(seed: int, scale: float = 1.0):
    rng = np.random.default_rng(seed)
    return {k: np.asarray(scale * rng.standard_normal(s), np.float32)
            for k, s in SHAPES.items()}


def assert_rel(want, got, what):
    want = np.asarray(want, dtype=np.float32)
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    tol = OPT_REL * max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol, what


OPT_CASES = {
    "defaults": {},
    "no_clip": dict(clip_norm=None),
    "clipped_hard": dict(clip_norm=0.05),
    "past_warmup": dict(warmup_steps=2, total_steps=10),
    "master_weights": dict(master_weights=True),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_adamw_update_equals_the_reference(case):
    """Four updates from the same parameters with a new gradient each time:
    parameters, both moments, the master copy and the metrics."""
    over = OPT_CASES[case]
    jcfg, tcfg = jax_adamw.AdamWConfig(**over), adamw.AdamWConfig(**over)
    p0 = leaves(0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jax_adamw.init(jcfg, jp), adamw.init(tcfg, tp)
    for i in range(4):
        g = leaves(10 + i, scale=0.3)
        jp, js, jm = jax_adamw.update(jcfg, jp, {k: jnp.asarray(v)
                                                 for k, v in g.items()}, js)
        tp, ts, tm = adamw.update(tcfg, tp, {k: torch.from_numpy(v)
                                             for k, v in g.items()}, ts)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        for key in ("grad_norm", "lr"):
            assert_rel(jm[key], tm[key], (case, i, key))
        for k in SHAPES:
            assert_rel(jp[k], tp[k], (case, i, "param", k))
            assert_rel(js["m"][k], ts["m"][k], (case, i, "m", k))
            assert_rel(js["v"][k], ts["v"][k], (case, i, "v", k))
            if tcfg.master_weights:
                assert_rel(js["master"][k], ts["master"][k], (case, i, k))


def test_adamw_schedule_equals_the_reference():
    for over in ({}, dict(warmup_steps=3, total_steps=12, min_lr_ratio=0.0)):
        jcfg, tcfg = jax_adamw.AdamWConfig(**over), adamw.AdamWConfig(**over)
        for step in (0, 1, 2, 5, 11, 50, 10_000, 20_000):
            assert_rel(jax_adamw.schedule(jcfg, jnp.int32(step)),
                       adamw.schedule(tcfg, step), (over, step))


def test_adamw_bfloat16_moments_and_parameters():
    """``moment_dtype="bfloat16"`` and bf16 parameters: the moments are
    stored in bf16 and the update computed in float32, as the reference's;
    held at bf16's resolution (2^-8 relative) where a float32 difference of
    one unit can round the other way."""
    over = dict(moment_dtype="bfloat16")
    jcfg, tcfg = jax_adamw.AdamWConfig(**over), adamw.AdamWConfig(**over)
    p0 = leaves(1)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()).bfloat16() for k, v in p0.items()}
    js, ts = jax_adamw.init(jcfg, jp), adamw.init(tcfg, tp)
    for i in range(3):
        g = leaves(20 + i, scale=0.3)
        jp, js, _ = jax_adamw.update(jcfg, jp, {k: jnp.asarray(v, jnp.bfloat16)
                                                for k, v in g.items()}, js)
        tp, ts, _ = adamw.update(tcfg, tp, {k: torch.from_numpy(v).bfloat16()
                                            for k, v in g.items()}, ts)
        for k in SHAPES:
            assert ts["m"][k].dtype == tp[k].dtype == torch.bfloat16
            for want, got in ((jp[k], tp[k]), (js["m"][k], ts["m"][k]),
                              (js["v"][k], ts["v"][k])):
                want = np.asarray(want, np.float32)
                tol = 2.0 ** -8 * max(float(np.abs(want).max()), 1e-30)
                assert float(np.abs(got.float().numpy() - want).max()) <= tol


def test_grad_compressor_equals_the_reference():
    """Three rounds of quantise / dequantise with error feedback, on the
    same gradients: the dequantised gradients and the carried residuals."""
    jc, tc = JaxCompressor(), GradCompressor()
    p0 = leaves(2)
    js = {"compress": jc.init({k: jnp.asarray(v) for k, v in p0.items()})}
    ts = {"compress": tc.init({k: torch.from_numpy(v)
                               for k, v in p0.items()})}
    for i in range(3):
        g = leaves(30 + i, scale=0.01 * (i + 1))
        jg, js = jc.apply({k: jnp.asarray(v) for k, v in g.items()}, js)
        tg, ts = tc.apply({k: torch.from_numpy(v) for k, v in g.items()}, ts)
        for k in SHAPES:
            assert_rel(jg[k], tg[k], (i, "grad", k))
            assert_rel(js["compress"]["ef"][k], ts["compress"]["ef"][k],
                       (i, "ef", k))
    off = GradCompressor(enabled=False)
    g = {k: torch.from_numpy(v) for k, v in leaves(3).items()}
    assert off.apply(g, ts) == (g, ts)


# --------------------------------------------------------------------------- #
# refusals, the launcher, isolation
# --------------------------------------------------------------------------- #


def test_the_kernel_entries_refuse_inputs_that_require_grad():
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 8, 2, 64), generator=g)
    k = torch.randn((1, 8, 1, 64), generator=g)
    with pytest.raises(RuntimeError, match="forward-only"):
        fa.flash_attention(q.requires_grad_(), k, k)
    with torch.no_grad():  # no graph is recorded: the kernel may run
        assert fa.flash_attention(q, k, k).shape == q.shape
    dt, x = torch.rand((1, 8, 4), generator=g), torch.randn((1, 8, 4),
                                                            generator=g)
    b = torch.randn((1, 8, 2), generator=g)
    a = -torch.rand((4, 2), generator=g)
    with pytest.raises(RuntimeError, match="forward-only"):
        ms.selective_scan(dt, x.requires_grad_(), b, b, a)
    with pytest.raises(RuntimeError, match="forward-only"):
        ms.selective_scan(dt, x.detach(), b, b, a.requires_grad_(),
                          backend="ref")
    y = ms.selective_scan(dt, x.detach(), b, b, a.detach())
    assert y.shape == (1, 8, 4)


def test_a_train_step_never_reaches_a_kernel_entry(monkeypatch):
    """The train path goes through ``cfg.attn_impl`` and the
    differentiable scan, never the kernel entries; asking it for flash or
    the scan kernel raises rather than dropping the gradient."""

    def boom(*a, **kw):
        raise AssertionError("a train step called a kernel entry")

    monkeypatch.setattr(fa, "flash_attention", boom)
    monkeypatch.setattr(ms, "selective_scan", boom)
    ocfg = adamw.AdamWConfig()
    runs = {}
    for arch in ("gemma3-4b", "jamba-1.5-large-398b"):
        cfg = dataclasses.replace(ARCHS[arch].reduced(), remat="none")
        model = fresh(cfg)
        model, _, m = make_train_step(cfg, ocfg)(
            model, opt_init(ocfg, model), batch(cfg, 2, 320, 0))
        assert np.isfinite(float(m["loss"]))
        runs[arch] = cfg, model
    monkeypatch.undo()
    cfg, model = runs["gemma3-4b"]
    with pytest.raises(RuntimeError, match="forward-only"):
        make_train_step(cfg, ocfg, impl="flash")(
            model, opt_init(ocfg, model), batch(cfg, 2, 320, 0))
    cfg, model = runs["jamba-1.5-large-398b"]
    with pytest.raises(RuntimeError, match="forward-only"):
        make_train_step(cfg, ocfg, scan_impl="kernel")(
            model, opt_init(ocfg, model), batch(cfg, 2, 320, 0))


def test_launch_train_resumes_bit_identically(tmp_path):
    """The driver on the CPU: 6 steps straight, and 6 steps with
    checkpoints every 3, the last one removed, then ``--resume`` from step
    3: the same losses."""
    args = ["--arch", "gemma3-4b", "--reduced", "--batch", "4", "--seq-len",
            "32", "--steps", "6", "--device", "cpu", "--log-every", "100"]
    straight = port_train.main(args)
    ck = tmp_path / "ck"
    port_train.main(args + ["--ckpt-dir", str(ck), "--ckpt-every", "3"])
    assert CheckpointManager(str(ck)).steps() == [3, 6]
    shutil.rmtree(ck / "step_6")
    resumed = port_train.main(args + ["--ckpt-dir", str(ck), "--resume",
                                      "--metrics-out",
                                      str(tmp_path / "m.json")])
    assert resumed["losses_tail"] == straight["losses_tail"][-3:]
    assert resumed["final_loss"] == straight["final_loss"]
    assert np.isfinite(straight["first_loss"])


def test_the_checkpoint_module_needs_no_ml_dtypes():
    src = (ROOT / "src" / "repro_torch" / "checkpoint" /
           "manager.py").read_text()
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert "ml_dtypes" not in names and "jax" not in names
