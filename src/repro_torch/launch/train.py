"""End-to-end training driver, the JAX package's ``launch/train.py`` on the
port: a config (reduced with ``--reduced``) trained for some steps on the
synthetic data pipeline, with AdamW, optional int8 gradient compression,
periodic async checkpoints, and crash-restart (``--resume`` restores the
latest checkpoint and continues bit-identically: the data pipeline is keyed
on the step).  It runs on the card unless ``--device cpu`` is given.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-4b \\
      --reduced --steps 200 --batch 8 --seq-len 128 --ckpt-dir /tmp/ck \\
      --ckpt-every 50
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import make_batch
from repro_torch.models.model import init_model
from repro_torch.optim import adamw
from repro_torch.optim.compress import GradCompressor
from repro_torch.train.step import batch_to, make_train_step


def train_state(model, opt_state) -> dict:
    """What a checkpoint holds: the parameters by name and the optimizer
    state."""
    return {"params": dict(model.named_parameters()), "opt": opt_state}


def load_train_state(model, restored) -> dict:
    """Write restored parameters into ``model`` in place; returns the
    restored optimizer state."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(restored["params"][name])
    return restored["opt"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains: cuda or cpu")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, remat="none")

    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=20,
                                total_steps=max(args.steps, 1))
    compressor = GradCompressor() if args.compress_grads else None

    dev = torch.device(args.device)
    model = init_model(cfg, torch.Generator(device=dev).manual_seed(args.seed),
                       device=dev)
    params = dict(model.named_parameters())
    opt_state = adamw.init(opt_cfg, params)
    if compressor is not None:
        opt_state["compress"] = compressor.init(params)

    start_step = 0
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt and args.resume and ckpt.latest_step() is not None:
        opt_state = load_train_state(
            model, ckpt.restore(train_state(model, opt_state)))
        start_step = int(opt_state["step"])
        print(f"resumed from step {start_step}")

    step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatches,
                              compressor=compressor)

    losses = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = batch_to(make_batch(cfg, args.batch, args.seq_len, step,
                                    seed=args.seed), dev)
        model, opt_state, metrics = step_fn(model, opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({(time.time()-t0):.1f}s)")
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, train_state(model, opt_state),
                      blocking=False)
    if ckpt:
        ckpt.save(args.steps, train_state(model, opt_state))

    out = {"final_loss": losses[-1] if losses else float("nan"),
           "first_loss": losses[0] if losses else float("nan"),
           "steps": args.steps, "losses_tail": losses[-5:]}
    if args.metrics_out:
        Path(args.metrics_out).write_text(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
