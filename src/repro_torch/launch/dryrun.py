"""Multi-node dry run: one train, prefill or decode step of an (arch x
shape) cell traced on a production mesh of H100s without a single card,
and its per-device roofline terms.

    python -m repro_torch.launch.dryrun --arch gemma3-4b --shape train_4k \\
        [--mesh single|multi|both] [--reduced] [--device cuda|cpu] ...

A fake process group (``torch.testing``'s ``FakeStore``, backend
``"fake"``) of ``REPRO_DRYRUN_DEVICES`` ranks (512 unless set) stands in
for the cluster: collectives return at once and move nothing.  The
parameters (:func:`repro_torch.models.params_shape`), the optimizer state
and the inputs (:mod:`repro_torch.launch.inputs`) become DTensors on the
mesh by the partition specs of :mod:`repro_torch.sharding.specs`, their
local shards ``meta`` tensors: nothing is allocated and nothing computed.
(Not ``FakeTensorMode``: under it DTensor's own bookkeeping of strided
shards makes fake index tensors and fails reading them.)  The step runs
under the activation rules (:func:`repro_torch.sharding.ctx.
sharding_rules`) and :class:`repro_torch.roofline.flops.OpCounter`, which
counts rank 0's local ops and the functional collectives DTensor issues.
The mesh's device type is ``--device``: ``cuda`` by default, ``cpu`` for a
machine without CUDA.

The record holds the counts per device and per step, the link bytes of the
collectives by the ring formulas of :mod:`repro_torch.roofline.hlo`, each
mesh axis at its own link (NVLink for the model axis inside a node,
InfiniBand for the others), the roofline terms at the H100's peaks
(:mod:`repro_torch.launch.mesh`) and, under ``memory``, rank 0's bytes as
the counter keeps them live through the step, with the reference's keys:

* ``argument_bytes``: the local shards of the step's arguments (the
  parameters; the optimizer state and the batch, the batch, or the decode
  cache and the token), a host int of a decode cache as the int32 scalar
  the reference keeps on the device;
* ``peak_bytes``: the most bytes live at once, the arguments included;
* ``output_bytes``: the storages of the returned tensors that are not the
  arguments' (a train step's metrics and step count, a prefill's logits,
  a decode step's logits);
* ``temp_bytes``: ``peak_bytes - argument_bytes - output_bytes``, at
  least 0;
* ``alias_bytes``: the argument storages the step writes in place: a
  train step updates the parameters and the AdamW moments, a decode step
  writes its cache (the reference donates them and aliases its outputs).

The reference's ``xla_cost`` (XLA's own cost analysis of the compiled
module) and ``compile_s`` have no counterpart, because nothing is
compiled: they are left out, and ``trace_s`` times the traced step.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import SHAPES, get_arch, param_counts
from repro_torch.configs import ARCHS, shape_applicable
from repro_torch.launch.inputs import input_specs
from repro_torch.launch.mesh import (HBM_BW, PEAK_FLOPS_BF16, link_bw,
                                     make_production_mesh)
from repro_torch.models.model import model_flops_per_token, params_shape
from repro_torch.models.layers import dtype_of
from repro_torch.optim import adamw
from repro_torch.roofline.flops import OpCounter, collective_link_bytes
from repro_torch.sharding import specs as sh
from repro_torch.sharding.ctx import sharding_rules
from repro_torch.train.step import (make_prefill_step, make_serve_step,
                                    make_train_step)

#: parameters above which weights and optimizer state shard over data too
FSDP_PARAM_THRESHOLD = 20e9
#: parameters above which the moments are bf16 and there is no fp32 master
BF16_OPT_THRESHOLD = 150e9
#: the fake world's size unless ``REPRO_DRYRUN_DEVICES`` sets it
DEVICES = 512


def opt_config(total_params: float) -> adamw.AdamWConfig:
    if total_params >= BF16_OPT_THRESHOLD:
        return adamw.AdamWConfig(moment_dtype="bfloat16", master_weights=False)
    return adamw.AdamWConfig(moment_dtype="float32", master_weights=False)


def init_fake_world() -> None:
    """The fake process group of ``REPRO_DRYRUN_DEVICES`` ranks (this
    process is rank 0), once per process."""
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group(
            "fake", store=FakeStore(), rank=0,
            world_size=int(os.environ.get("REPRO_DRYRUN_DEVICES", DEVICES)))


def make_mesh(multi_pod: bool, reduced: bool, device: str):
    """The production mesh, or for ``reduced`` cells (2, 2) / (2, 2, 2)."""
    if not reduced:
        return make_production_mesh(multi_pod=multi_pod, device_type=device)
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 2, 2) if multi_pod else (2, 2)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def _local_shape(shape, spec, mesh):
    sizes = sh.mesh_axes(mesh)
    out = list(shape)
    for i, axes in enumerate(spec):
        if axes is not None:
            out[i] //= sh.axis_size(sizes, axes)
    return out


def distribute(t: torch.Tensor, spec, mesh, device: str):
    """A DTensor of ``t``'s shape and dtype on ``mesh`` by ``spec``, its
    local shard a ``meta`` tensor."""
    from torch.distributed.tensor import DTensor

    local = torch.empty(_local_shape(t.shape, spec, mesh), dtype=t.dtype,
                        device="meta")
    return DTensor.from_local(local, mesh, sh.to_placements(spec, mesh),
                              run_check=False, shape=t.shape,
                              stride=torch.empty(t.shape, device="meta")
                              .stride())


def _local_bytes(tree) -> int:
    """Bytes of the local shards in ``tree``; a host int (a decode cache's
    ``pos`` / ``cache_len``) counts as the int32 scalar the reference
    keeps on the device."""
    if isinstance(tree, bool):
        return 0
    if isinstance(tree, int):
        return 4
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        local = tree.to_local() if hasattr(tree, "to_local") else tree
        return local.numel() * local.element_size()
    return 0


def _distribute_cache(cache, specs, mesh, device, prefix=""):
    if isinstance(cache, dict):
        return {k: _distribute_cache(v, specs, mesh, device,
                                     f"{prefix}/{k}" if prefix else k)
                for k, v in cache.items()}
    if isinstance(cache, list):
        return [_distribute_cache(v, specs, mesh, device, f"{prefix}/{i}")
                for i, v in enumerate(cache)]
    if isinstance(cache, torch.Tensor):
        return distribute(cache, specs[prefix], mesh, device)
    return cache  # pos, cache_len: host ints


def collective_terms(collectives, mesh):
    """kind -> {count, result_bytes, link_bytes} per device per step, link
    bytes and seconds by mesh axis, from the counter's ``(kind, result
    bytes, group name)``."""
    groups = {mesh.get_group(d).group_name: d for d in mesh.mesh_dim_names}
    summary, by_axis = {}, {d: 0.0 for d in mesh.mesh_dim_names}
    for kind, result_bytes, group in collectives:
        axis = groups.get(group)
        if axis is None:
            raise ValueError(f"a {kind} on group {group!r}, no axis of "
                             f"{mesh}")
        link = collective_link_bytes(kind, result_bytes,
                                     mesh.size(mesh.mesh_dim_names
                                               .index(axis)))
        e = summary.setdefault(kind, {"count": 0.0, "result_bytes": 0.0,
                                      "link_bytes": 0.0})
        e["count"] += 1
        e["result_bytes"] += result_bytes
        e["link_bytes"] += link
        by_axis[axis] += link
    seconds = sum(b / link_bw(a) for a, b in by_axis.items())
    return summary, by_axis, seconds


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             reduced: bool = False, overrides=None,
             device: str = "cuda") -> dict:
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    overrides = dict(overrides) if overrides else {}
    tp2d = bool(overrides.pop("tp2d", False))
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x32x8" if multi_pod else "32x8", "kind": shape.kind,
           "device": device}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        rec["status"] = "skipped"
        rec["why"] = why
        return rec

    init_fake_world()
    mesh = make_mesh(multi_pod, reduced, device)
    rec["mesh"] = "x".join(map(str, mesh.shape))
    n_chips = mesh.size()
    total, active = param_counts(cfg)
    fsdp = total >= FSDP_PARAM_THRESHOLD
    B = shape.global_batch
    from torch.distributed.tensor.experimental import implicit_replication

    t0 = time.time()
    model = params_shape(cfg)
    pspecs = sh.param_specs(dict(model.named_parameters()), mesh,
                            fsdp=fsdp, tp2d=tp2d)
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(owner), leaf, torch.nn.Parameter(
            distribute(p, pspecs[name], mesh, device),
            requires_grad=False))
    params = dict(model.named_parameters())
    ins = input_specs(cfg, shape)
    args = [model]
    if shape.kind == "train":
        ocfg = opt_config(total)
        mdt = dtype_of(ocfg.moment_dtype)
        ospecs = sh.opt_state_specs(pspecs, {}, mesh)
        opt = {k: {n: distribute(torch.empty(p.shape, dtype=mdt,
                                             device="meta"),
                                 ospecs[k][n], mesh, device)
                   for n, p in params.items()} for k in ("m", "v")}
        opt["step"] = torch.zeros((), dtype=torch.int32, device="meta")
        bspecs = sh.batch_specs(ins["batch"], mesh, batch=B)
        batch = {k: distribute(v, bspecs[k], mesh, device)
                 for k, v in ins["batch"].items()}
        args += [opt, batch]
        step = make_train_step(cfg, ocfg)
    elif shape.kind == "prefill":
        bspecs = sh.batch_specs(ins["batch"], mesh, batch=B)
        batch = {k: distribute(v, bspecs[k], mesh, device)
                 for k, v in ins["batch"].items()}
        args += [batch]
        # the differentiable scan, as the reference's prefill runs its
        # jnp scan: the scan kernel cannot run on meta tensors
        step = make_prefill_step(cfg, scan_impl="chunked")
    else:  # decode
        cspecs = sh.cache_specs(ins["cache"], mesh, batch=B, tp2d=tp2d)
        cache = _distribute_cache(ins["cache"], cspecs, mesh, device)
        tspec = sh.batch_specs({"token": ins["token"]}, mesh, batch=B)
        token = distribute(ins["token"], tspec["token"], mesh, device)
        args += [cache, token]
        step = make_serve_step(cfg)
    arg_bytes = _local_bytes(args[1:]) + _local_bytes(params)
    rules = sh.activation_rules(cfg, mesh, batch=B)
    with sharding_rules(rules), implicit_replication(), \
            OpCounter(hold=args) as counter:
        out = step(*args)
    t_trace = time.time() - t0

    colls, link_by_axis, collective_s = collective_terms(
        counter.collectives, mesh)
    link_bytes = sum(link_by_axis.values())
    flops_pd, bytes_pd = counter.flops, counter.bytes
    compute_s = flops_pd / PEAK_FLOPS_BF16
    memory_s = bytes_pd / HBM_BW

    # MODEL_FLOPS: 6*N*D for training (fwd 2 + bwd 4), 2*N*D for inference
    tokens = B * (shape.seq_len if shape.kind in ("train", "prefill") else 1)
    per_token = model_flops_per_token(cfg)  # = 6*N_active
    if shape.kind != "train":
        per_token /= 3.0  # 2*N_active
    model_flops_pd = per_token * tokens / n_chips

    dom = max(("compute", compute_s), ("memory", memory_s),
              ("collective", collective_s), key=lambda kv: kv[1])[0]
    rec.update({
        "status": "ok",
        "n_chips": n_chips,
        "fsdp": fsdp,
        "trace_s": round(t_trace, 2),
        "memory": counter.memory(out, arg_bytes),
        "loop_aware": {"flops_per_device": flops_pd,
                       "bytes_per_device": bytes_pd,
                       "product_flops_per_device": counter.product_flops,
                       "ops": counter.ops},
        "collectives": colls,
        "collective_link_bytes_per_device": link_bytes,
        "collective_link_bytes_by_axis": link_by_axis,
        "roofline": {
            "compute_s": compute_s,
            "memory_s": memory_s,
            "collective_s": collective_s,
            "dominant": dom,
        },
        "model_flops_per_device": model_flops_pd,
        "useful_flops_ratio": (model_flops_pd / flops_pd) if flops_pd else 0.0,
        "params_total": total,
        "params_active": active,
    })
    return rec


def parse_overrides(pairs) -> dict:
    """``--set key=value`` pairs as config overrides, each value as JSON
    where it parses (``attn_chunk=1024``), else as the string."""
    overrides = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v
    return overrides


def cells(archs=None, shapes=None):
    for a in (archs or ARCHS):
        for s in (shapes or SHAPES):
            yield a, s


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="multi-node dry run: trace one step on fake ranks, "
        "roofline terms at the H100's peaks")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced configs on a (2, 2) / (2, 2, 2) mesh")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the mesh's device type (nothing runs on it)")
    ap.add_argument("--subprocess", action="store_true",
                    help="run each cell in a fresh process")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (e.g. attn_chunk=1024)")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    overrides = parse_overrides(args.set)

    failures = 0
    for a, s in cells(archs, shapes):
        for mp in meshes:
            tag = f"{a}_{s}_{'multi' if mp else 'single'}"
            path = out_dir / f"{tag}.json"
            if args.subprocess:
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", a, "--shape", s, "--mesh",
                       "multi" if mp else "single", "--out", str(out_dir),
                       "--device", args.device]
                if args.reduced:
                    cmd.append("--reduced")
                for kv in args.set:
                    cmd += ["--set", kv]
                r = subprocess.run(cmd, capture_output=True, text=True)
                tail = "\n".join(r.stdout.splitlines()[-3:])
                print(f"[{tag}] rc={r.returncode} {tail}")
                if r.returncode != 0:
                    failures += 1
                    print(r.stderr[-2000:])
                continue
            try:
                rec = run_cell(a, s, mp, reduced=args.reduced,
                               overrides=overrides, device=args.device)
            except Exception:  # the record carries the traceback
                rec = {"arch": a, "shape": s,
                       "mesh": "2x32x8" if mp else "32x8",
                       "status": "error", "traceback": traceback.format_exc()}
                failures += 1
            path.write_text(json.dumps(rec, indent=1, default=float))
            if rec["status"] == "ok":
                r = rec["roofline"]
                print(f"[{tag}] ok trace={rec['trace_s']}s "
                      f"peak={rec['memory']['peak_bytes'] / 1e9:.3f}GB "
                      f"compute={r['compute_s']*1e3:.2f}ms "
                      f"memory={r['memory_s']*1e3:.2f}ms "
                      f"collective={r['collective_s']*1e3:.2f}ms "
                      f"dominant={r['dominant']} "
                      f"useful={rec['useful_flops_ratio']:.2f}")
            elif rec["status"] == "skipped":
                print(f"[{tag}] SKIP: {rec['why']}")
            else:
                print(f"[{tag}] ERROR (see {path})")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
