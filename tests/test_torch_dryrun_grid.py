"""The port's dry run where it failed to trace on a production mesh, or
made a tensor of the global shape on every device, reduced on 8 fake
ranks on the CPU; and the sharded loss and train step on 4 gloo
processes against the plain ones.

Each test names the fault it guards:

* decode with fewer kv heads than the model axis has ranks: the query's
  reshape into kv-head groups could not split the model-axis shards
  (``Cannot unflatten unevenly sharded tensor``);
* AdamW on a zero-width leaf whose gradient came out of autograd as
  ``(Partial, Shard(0))`` against a ``(Replicate, Shard(1))`` moment: the
  in-place moment write needed a placement change;
* the MoE FFN with a global batch smaller than the data ranks: the tokens'
  reshape back to ``[B, S, D]`` cut inside a row;
* the label gather of ``lm_loss`` (its backward made zeros of the global
  ``[tokens, vocab]`` logits), ``causal_conv``'s zero context and
  accumulator, and the MoE routing's zeros (at the global group count),
  each a tensor of the global shape on every device;
* the sharded backward: the ``local_map`` sites whose replicated inputs
  feed work split over a mesh axis returned one rank's partial gradient
  as the whole one.

The subprocesses run as ``tests/test_torch_dryrun.py``'s do: niced, one
compute thread each, a few at a time.
"""
import json
import math
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

from tests.test_torch_dryrun import NICE, _run_all  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

#: the reduced cells the peak probe runs on the (2, 2, 2) mesh, and their
#: overrides: fewer ops to trace (fewer loss, attention and scan chunks,
#: one period of gemma's layers), the same tensors
PROBES = {
    ("gemma3-4b", "train_4k"): ["n_layers=6", "attn_chunk=1024",
                                "loss_chunk=65536"],
    ("falcon-mamba-7b", "prefill_32k"): ["scan_chunk=4096"],
    ("qwen3-moe-30b-a3b", "prefill_32k"): [],
}

#: a cell's shapes on rank 0: every storage the step made, by the op
#: that made it first, and the record's memory
PROBE = textwrap.dedent('''
    import json, os, sys
    os.nice(19)
    sys.path.insert(0, "tools")
    import dryrun_peak
    from repro_torch.launch import dryrun

    shapes = {}

    class Probe(dryrun_peak.PeakProbe):
        def _add(self, t):
            super()._add(t)
            shapes.setdefault(tuple(t.shape), self.op)

    dryrun.OpCounter = Probe
    rec = dryrun.run_cell(sys.argv[1], sys.argv[2], True, reduced=True,
                          overrides=dryrun.parse_overrides(sys.argv[3:]),
                          device="cpu")
    print("RESULT " + json.dumps({
        "status": rec["status"], "memory": rec["memory"],
        "shapes": [[list(s), op] for s, op in shapes.items()]}))
''')

#: AdamW on a zero-width leaf and a 2-D one, and the MoE FFN with a
#: global batch of 2 over 4 data ranks, on 8 fake ranks
UNITS = textwrap.dedent('''
    import json, os
    os.nice(19)
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import ARCHS
    from repro_torch.launch import dryrun
    from repro_torch.models.model import params_shape
    from repro_torch.models.moe import moe_ffn
    from repro_torch.optim import adamw
    from repro_torch.roofline.flops import OpCounter
    from repro_torch.sharding import specs as sh
    from repro_torch.sharding.ctx import sharding_rules

    dryrun.init_fake_world()
    out = {}

    def dtensor(shape, placements, mesh):
        local = list(shape)
        for d, p in enumerate(placements):
            if p.is_shard():
                local[p.dim] //= mesh.size(d)
        return DTensor.from_local(
            torch.empty(local, device="meta"), mesh, placements,
            run_check=False, shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride())

    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    moment = [Replicate(), Shard(1)]
    for name, shape in (("zero_width", (4096, 0)), ("two_d", (8, 8))):
        params = {"w": dtensor(shape, moment, mesh)}
        grads = {"w": dtensor(shape, [Partial(), Shard(0)], mesh)}
        state = {"m": {"w": dtensor(shape, moment, mesh)},
                 "v": {"w": dtensor(shape, moment, mesh)},
                 "step": torch.zeros((), dtype=torch.int32, device="meta")}
        try:
            with implicit_replication(), OpCounter() as c:
                adamw.update(adamw.AdamWConfig(), params, grads, state)
            out[name] = {
                "placements": [str(t.placements) for t in
                               (params["w"], state["m"]["w"],
                                state["v"]["w"])],
                "collective_bytes": [b for _, b, _ in c.collectives]}
        except Exception as e:  # noqa: BLE001
            out[name] = {"error": repr(e)[:500]}

    mesh = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    cfg = ARCHS["qwen3-moe-30b-a3b"].reduced()
    moe = params_shape(cfg).layers[0].moe
    specs = sh.param_specs(dict(moe.named_parameters(prefix="layers.0.moe")),
                           mesh, fsdp=False)
    for name, p in list(moe.named_parameters()):
        setattr(moe, name, torch.nn.Parameter(dryrun.distribute(
            p, specs["layers.0.moe." + name], mesh, "cpu"),
            requires_grad=False))
    B, S = 2, 512  # 16 groups of 64 over 4 data ranks; 2 rows
    x = dryrun.distribute(torch.empty((B, S, cfg.d_model), device="meta"),
                          (None, None, None), mesh, "cpu")
    try:
        with sharding_rules(sh.activation_rules(cfg, mesh, batch=B)), \\
                implicit_replication(), torch.no_grad():
            y = moe_ffn(moe, x, cfg.moe, cfg.mlp_type)
        out["moe"] = {"shape": list(y.shape)}
    except Exception as e:  # noqa: BLE001
        out["moe"] = {"error": repr(e)[:500]}
    print("RESULT " + json.dumps(out))
''')


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The decode cell on both meshes, the peak probes and the unit checks
    on fake ranks, their output in ``<key>.log``; returns the output
    directory and ``{key: return code}``."""
    out = tmp_path_factory.mktemp("grid")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_DRYRUN_DEVICES="8", OMP_NUM_THREADS="1")
    jobs = {(arch,): (["-c", PROBE, arch, shape, *over], f"probe_{arch}.log")
            for (arch, shape), over in PROBES.items()}
    jobs[("decode",)] = (
        ["-c", NICE, "repro_torch.launch.dryrun", "--reduced", "--device",
         "cpu", "--out", str(out), "--arch", "gemma3-4b", "--shape",
         "decode_32k", "--mesh", "both", "--set", "n_heads=6", "--set",
         "n_kv_heads=3"], "decode.log")
    jobs[("units",)] = (["-c", UNITS], "units.log")
    return out, _run_all(jobs, out, env)


def _result(out: Path, log: str) -> dict:
    text = (out / log).read_text()
    assert "RESULT " in text, text[-3000:]
    return json.loads(text.split("RESULT ", 1)[1].splitlines()[0])


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_decode_with_fewer_kv_heads_than_model_ranks_traces(runs, mesh):
    """Fault: the decode query's reshape into 3 kv-head groups over a model
    axis of 2 (``Cannot unflatten unevenly sharded tensor``)."""
    out, done = runs
    assert done[("decode",)] == 0, (out / "decode.log").read_text()[-3000:]
    rec = json.loads((out / f"gemma3-4b_decode_32k_{mesh}.json")
                     .read_text())
    assert rec["status"] == "ok", rec.get("traceback", rec)[-3000:]
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]


@pytest.mark.parametrize("leaf", ["zero_width", "two_d"])
def test_adamw_takes_a_gradient_in_another_layout(runs, leaf):
    """Fault: ``m.copy_`` of a moment computed from a ``(Partial,
    Shard(0))`` gradient into a ``(Replicate, Shard(1))`` moment (a placement
    change in place).  The parameter and the moments keep their layout, and
    the zero-width leaf's collectives move no more than the float32 scalars
    of the gradient norm."""
    out, _ = runs
    got = _result(out, "units.log")[leaf]
    assert "error" not in got, got
    want = "(Replicate(), Shard(dim=1))"
    assert got["placements"] == [want] * 3
    if leaf == "zero_width":
        assert max(got["collective_bytes"]) <= 4, got


def test_moe_with_fewer_rows_than_data_ranks_keeps_its_shape(runs):
    """Fault: ``moe_ffn``'s reshape of 16 groups split over 4 data ranks
    back to a batch of 2 rows."""
    out, _ = runs
    got = _result(out, "units.log")["moe"]
    assert got == {"shape": [2, 512, 64]}


def _global_shapes(arch: str, shape: str, over) -> list:
    """Leading sizes that only a tensor of the cell's global shape has, of
    tensors the specs split over data: [B, S, ...] activations, the loss's
    [rows, vocab] logits, the MoE's [G, ...] groups and [B * S, ...]
    tokens.  On (2, 2, 2) a local tensor has a quarter of such a size, a
    reduce-scatter's staging tensor half."""
    from repro_torch.configs import SHAPES, get_arch

    cfg = get_arch(arch).reduced()
    s = SHAPES[shape]
    B, S = s.global_batch, s.seq_len
    out = [(B, S)]
    kv = dict(x.split("=") for x in over)
    if s.kind == "train":
        chunk = min(int(kv.get("loss_chunk", cfg.loss_chunk)), B * S // 4)
        out.append((4 * chunk, cfg.vocab))
    if cfg.moe is not None:
        out += [(B * S // cfg.moe.group_size,), (B * S,)]
    return out


@pytest.mark.parametrize("arch,shape", list(PROBES))
def test_no_tensor_of_the_global_shape_on_a_device(runs, arch, shape):
    """Faults: ``lm_loss``'s label gather (gemma3-4b train_4k: zeros of the
    global [rows, vocab] logits in its backward), ``causal_conv``'s zeros
    (falcon-mamba-7b prefill_32k: a float32 [B, S, d_inner]), the MoE
    routing's zeros (qwen3-moe-30b-a3b prefill_32k: [G, n, E, cap] at the
    global group count).  No storage the step makes on rank 0 has a global
    size of a tensor the cell splits over data."""
    out, done = runs
    assert done[(arch,)] == 0, (out / f"probe_{arch}.log").read_text()[-3000:]
    got = _result(out, f"probe_{arch}.log")
    assert got["status"] == "ok"
    forbidden = _global_shapes(arch, shape, PROBES[(arch, shape)])
    bad = [s for s in got["shapes"]
           if any(tuple(s[0][:len(f)]) == f for f in forbidden)]
    print(f"{arch} {shape} 2x2x2: {got['memory']}, "
          f"{len(got['shapes'])} shapes")
    assert not bad, bad


GLOO_TRAIN = textwrap.dedent('''
    import dataclasses, sys
    import torch, torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import init_model
    from repro_torch.models.model import model_loss
    from repro_torch.optim import adamw
    from repro_torch.sharding import specs as sh
    from repro_torch.sharding.ctx import sharding_rules
    from repro_torch.train.step import batch_to, make_train_step

    rank, world, shape = int(sys.argv[1]), int(sys.argv[2]), eval(sys.argv[3])
    dist.init_process_group("gloo", init_method=sys.argv[4], rank=rank,
                            world_size=world)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    ocfg = adamw.AdamWConfig(warmup_steps=1)
    B, S = 4, 64
    full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
    worst = {}
    for arch, fsdp in [(a, f) for a in ("gemma3-4b", "falcon-mamba-7b",
                                         "qwen3-moe-30b-a3b")
                       for f in (False, True)]:
        cfg = dataclasses.replace(ARCHS[arch].reduced(), remat="none")
        batch = batch_to(make_batch(cfg, B, S, 0), "cpu")
        step = make_train_step(cfg, ocfg)
        runs = []
        for sharded in (False, True):
            model = init_model(cfg, torch.Generator().manual_seed(3), "cpu")
            b = batch
            if sharded:
                specs = sh.param_specs(dict(model.named_parameters()), mesh,
                                       fsdp=fsdp)
                for name, p in list(model.named_parameters()):
                    owner, _, leaf = name.rpartition(".")
                    setattr(model.get_submodule(owner), leaf,
                            torch.nn.Parameter(distribute_tensor(
                                p, mesh, sh.to_placements(specs[name],
                                                          mesh)),
                                requires_grad=False))
                bspecs = sh.batch_specs(batch, mesh, batch=B)
                b = {k: distribute_tensor(v, mesh, sh.to_placements(
                    bspecs[k], mesh)) for k, v in batch.items()}
            rules = sh.activation_rules(cfg, mesh, batch=B) if sharded \\
                else None
            with sharding_rules(rules), implicit_replication():
                with torch.no_grad():
                    loss = model_loss(cfg, model, b, scan_impl="chunked")
                params = dict(model.named_parameters())
                model, _, m = step(model, adamw.init(ocfg, params), b)
            runs.append([full(loss), full(m["loss"]), full(m["grad_norm"])]
                        + [full(p) for p in model.parameters()])
        key = arch + (" fsdp" if fsdp else "")
        worst[key] = max(
            float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
            for g, w in zip(runs[1], runs[0]))
        if shape == (1, 1) and not all(
                torch.equal(g, w) for g, w in zip(runs[1], runs[0])):
            worst[key] = float("inf")
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
def test_a_sharded_train_step_gives_the_plain_one(shape):
    """Fault: the sharded backward.  Reduced gemma3-4b, falcon-mamba-7b
    and qwen3-moe-30b-a3b (float32, B = 4, S = 64), their parameters and
    batch distributed by the specs on gloo ranks, with and without FSDP
    (the weights' input dims over the data axes): the loss, and one train
    step's loss, gradient norm and every updated parameter, within 1e-4 x
    max(1, |value|) of the plain step's on a (2, 2) mesh, equal on (1, 1)."""
    world = math.prod(shape)
    init = f"tcp://localhost:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", GLOO_TRAIN, str(r), str(world), repr(shape),
         init], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    outs = [p.communicate(timeout=600) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs[0][1][-3000:]
    worst = eval(outs[0][0].split("WORST", 1)[1])
    bound = 0.0 if shape == (1, 1) else 1e-4
    print(f"{shape}: {worst}")
    assert all(v <= bound for v in worst.values()), worst
