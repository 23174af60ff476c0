"""The port's sharding rules against the reference's, on the CPU.

For every arch, reduced, on the meshes the reduced dry run uses ((2, 2)
and (2, 2, 2), as ``jax.sharding.AbstractMesh`` for the reference and as
axis sizes for the port): each parameter's spec (with ``fsdp`` and
``tp2d`` both ways) equals the reference's spec of the leaf
``flatten_jax_params`` takes it from, less the reference's leading
scan-group axis; likewise each decode-cache leaf's, the activation rules
and the batch specs.  ``to_placements`` turns a spec into DTensor
placements.  Then the models' ``shard`` call sites on real DTensors: a
reduced prefill on a (2, 2) mesh of four gloo processes gives the
unsharded logits within 1e-4 (tensor-parallel partial sums add in another
order), and on a (1, 1) mesh of one the same logits bit for bit.
"""
import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# torch's intra-op threads: this pytest-xdist worker's share of the cores
torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", 1))))

jax = pytest.importorskip("jax")
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.launch.inputs import batch_struct as jax_batch_struct  # noqa: E402
from repro.models import init_cache as jax_init_cache  # noqa: E402
from repro.models.model import params_shape as jax_params_shape  # noqa: E402
from repro.sharding import specs as jsh  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.launch.inputs import batch_struct  # noqa: E402
from repro_torch.models import encdec as ed  # noqa: E402
from repro_torch.models import params_shape  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.sharding import specs as sh  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
MODES = {"plain": dict(fsdp=False, tp2d=False),
         "fsdp": dict(fsdp=True, tp2d=False),
         "tp2d": dict(fsdp=False, tp2d=True),
         "fsdp+tp2d": dict(fsdp=True, tp2d=True)}
DECODES = ("decode_32k", "long_500k")


def meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), dict(zip(axes, shape))


def norm(spec):
    """A spec entry by entry: ``None`` or the tuple of its axis names."""
    return tuple(None if a is None else (a,) if isinstance(a, str)
                 else tuple(a) for a in spec)


def _path(path) -> list:
    return [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]


def by_port_name(jcfg, tree):
    """The reference's ``{path: spec}`` of a parameter or cache pytree as
    ``{the port's name: spec}``: a stacked leaf (``layers/<p>``, ``enc``,
    ``dec``, an enc-dec cache's ``layers``) gives one entry per layer with
    the leading scan-group entry dropped (it must be unsharded); a
    ``tail/<t>`` leaf is layer ``n_groups * period + t``."""
    out = {}
    n_stacked = jcfg.n_groups * jcfg.period

    def put(names, spec, drop: bool):
        if drop:
            assert spec[0] is None, (names, spec)
            spec = spec[1:]
        for name in names:
            out[name] = norm(spec)

    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]
    for path, s in flat:
        p = _path(path)
        spec = tuple(s.spec)
        if p[0] == "layers" and jcfg.family == "encdec":
            put([f"layers.{i}.{'.'.join(p[1:])}"
                 for i in range(jcfg.n_layers)], spec, True)
        elif p[0] == "layers":
            rest = ".".join(p[2:])
            put([f"layers.{g * jcfg.period + int(p[1])}.{rest}"
                 for g in range(jcfg.n_groups)], spec, True)
        elif p[0] == "tail":
            put([f"layers.{n_stacked + int(p[1])}.{'.'.join(p[2:])}"], spec,
                False)
        elif p[0] in ("enc", "dec"):
            n = jcfg.enc_layers if p[0] == "enc" else jcfg.n_layers
            put([f"{p[0]}.{i}.{'.'.join(p[1:])}" for i in range(n)], spec,
                True)
        else:
            put([".".join(p)], spec, False)
    return out


@functools.lru_cache(maxsize=None)
def configs(arch):
    return JAX_ARCHS[arch].reduced(), ARCHS[arch].reduced()


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_equal_the_reference(arch, mesh, mode):
    jcfg, tcfg = configs(arch)
    jmesh, axes = meshes(mesh)
    want = by_port_name(jcfg, jsh.param_specs(jax_params_shape(jcfg), jmesh,
                                              **MODES[mode]))
    got = sh.param_specs(dict(params_shape(tcfg).named_parameters()), axes,
                         **MODES[mode])
    assert sorted(got) == sorted(want)
    assert {k: norm(v) for k, v in got.items()} == want
    opt = sh.opt_state_specs(got, {}, axes)
    assert opt["m"] is got and opt["v"] is got and opt["step"] == ()


@pytest.mark.parametrize("tp2d", [False, True], ids=["tp", "tp2d"])
@pytest.mark.parametrize("shape", DECODES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_equal_the_reference(arch, mesh, shape, tp2d):
    """Batch 128 over the data axes, or a single long sequence over them
    (long_500k's batch of 1): every cache leaf's spec."""
    jcfg, tcfg = configs(arch)
    jmesh, axes = meshes(mesh)
    S, B = SHAPES[shape].seq_len, SHAPES[shape].global_batch
    if tcfg.family == "encdec":
        jc = jax.eval_shape(lambda: jax_init_cache(jcfg, B, S // 2,
                                                   enc_len=S // 2))
        tc = ed.encdec_init_cache(tcfg, B, S // 2, S // 2, device="meta")
    else:
        jc = jax.eval_shape(lambda: jax_init_cache(jcfg, B, S))
        tc = tf.init_cache(tcfg, B, S, device="meta")
    want = by_port_name(jcfg, jsh.cache_specs(jc, jmesh, batch=B, tp2d=tp2d))
    assert want.pop("pos") == () and want.pop("cache_len", ()) == ()
    got = sh.cache_specs(tc, axes, batch=B, tp2d=tp2d)
    assert {k.replace("/", "."): norm(v) for k, v in got.items()} == want


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_activation_rules_and_batch_specs_equal_the_reference(arch, mesh,
                                                              shape):
    jcfg, tcfg = configs(arch)
    jmesh, axes = meshes(mesh)
    B = SHAPES[shape].global_batch
    want = jsh.activation_rules(jcfg, jmesh, batch=B)
    got = sh.activation_rules(tcfg, axes, batch=B)
    assert {k: norm(v) for k, v in got.items()} == \
        {k: norm(tuple(v.spec)) for k, v in want.items()}
    jb = jax_batch_struct(jcfg, JAX_SHAPES[shape], with_labels=True)
    tb = batch_struct(tcfg, SHAPES[shape], with_labels=True)
    assert {k: (tuple(v.shape), v.dtype.itemsize) for k, v in tb.items()} \
        == {k: (tuple(v.shape), v.dtype.itemsize) for k, v in jb.items()}
    want = jsh.batch_specs(jb, jmesh, batch=B)
    got = sh.batch_specs(tb, axes, batch=B)
    assert {k: norm(v) for k, v in got.items()} == \
        {k: norm(tuple(v.spec)) for k, v in want.items()}


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:  # the one attribute to_placements reads
        mesh_dim_names = ("pod", "data", "model")

    assert sh.to_placements((("pod", "data"), None, "model"), Mesh) == \
        [Shard(0), Shard(0), Shard(2)]
    assert sh.to_placements((None, ("data", "model")), Mesh) == \
        [Replicate(), Shard(1), Shard(1)]
    assert sh.to_placements(((), None), Mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        sh.to_placements((("model", "data"),), Mesh)


# --------------------------------------------------------------------------- #
# the shard call sites on real DTensors
# --------------------------------------------------------------------------- #

SHARDED_PREFILL = textwrap.dedent('''
    import dataclasses, os, sys
    import torch, torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import init_model
    from repro_torch.sharding import specs as sh
    from repro_torch.sharding.ctx import sharding_rules
    from repro_torch.train.step import batch_to, make_prefill_step

    rank, world, shape = int(sys.argv[1]), int(sys.argv[2]), eval(sys.argv[3])
    dist.init_process_group("gloo", init_method=sys.argv[4], rank=rank,
                            world_size=world)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    worst = {}
    for arch in ("gemma3-4b", "qwen3-moe-30b-a3b"):
        cfg = dataclasses.replace(ARCHS[arch].reduced(), remat="none")
        model = init_model(cfg, torch.Generator().manual_seed(3), "cpu")
        batch = batch_to(make_batch(cfg, 4, 320, 0), "cpu")
        step = make_prefill_step(cfg)
        want = step(model, batch)
        specs = sh.param_specs(dict(model.named_parameters()), mesh,
                               fsdp=False)
        for name, p in list(model.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            setattr(model.get_submodule(owner), leaf, torch.nn.Parameter(
                distribute_tensor(p, mesh, sh.to_placements(specs[name],
                                                            mesh)),
                requires_grad=False))
        bspecs = sh.batch_specs(batch, mesh, batch=4)
        batch = {k: distribute_tensor(v, mesh, sh.to_placements(bspecs[k],
                                                                mesh))
                 for k, v in batch.items()}
        with sharding_rules(sh.activation_rules(cfg, mesh, batch=4)), \\
                implicit_replication():
            got = step(model, batch).full_tensor()
        worst[arch] = float((got - want).abs().max()) / max(
            1.0, float(want.abs().max()))
        if shape == (1, 1) and not torch.equal(got, want):
            worst[arch] = float("inf")
    if rank == 0:
        print("WORST", worst)
    dist.destroy_process_group()
''')


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("shape", [(2, 2), (1, 1)], ids=["2x2", "1x1"])
def test_a_sharded_prefill_gives_the_unsharded_logits(shape):
    """Reduced gemma3-4b and qwen3-moe-30b-a3b (float32), B = 4, S = 320
    (the chunked attention), their parameters and batch distributed by the
    specs and the prefill run under the activation rules on gloo ranks:
    the last position's logits within 1e-4 x max(1, |logit|) of the plain
    prefill's on a (2, 2) mesh, equal on (1, 1)."""
    world = shape[0] * shape[1]
    init = f"tcp://localhost:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", SHARDED_PREFILL, str(r), str(world),
         repr(shape), init], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    outs = [p.communicate(timeout=600) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs[0][1][-3000:]
    worst = eval(outs[0][0].split("WORST", 1)[1])
    bound = 0.0 if shape == (1, 1) else 1e-4
    assert all(v <= bound for v in worst.values()), worst
