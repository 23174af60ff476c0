"""Serving driver: stands up the aAPP-placement engine over a cell topology
and runs a request trace against a real model on the port, on the card
unless ``--device cpu`` is given.

Example (a reduced model, as the JAX package's launcher runs):
  PYTHONPATH=src python -m repro_torch.launch.serve --requests 50 --sessions 8
"""
from __future__ import annotations

import argparse
import random
import statistics
import time

import torch

from repro_torch.cluster.topology import two_pod_cells
from repro_torch.configs import get_arch
from repro_torch.models import init_cache, init_model, model_decode_step
from repro_torch.serve.engine import Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--requests", type=int, default=50)
    ap.add_argument("--sessions", type=int, default=8)
    ap.add_argument("--with-train-tenant", action="store_true")
    ap.add_argument("--fail-cell-at", type=int, default=-1,
                    help="inject a cell failure after N requests")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model and the scheduler run: cuda or cpu")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch).reduced()
    dev = torch.device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = init_model(cfg, gen, device=dev)
    caches = {}

    def runner(req: Request, cell: str):
        if req.kind == "prefill":
            caches[(req.session, cell)] = init_cache(cfg, 1, 128, device=dev)
            return None
        if req.kind == "decode":
            key = (req.session, cell)
            if key not in caches:
                caches[key] = init_cache(cfg, 1, 128, device=dev)
            with torch.no_grad():
                logits, caches[key] = model_decode_step(
                    cfg, model, caches[key],
                    torch.zeros((1, 1), dtype=torch.long, device=dev))
            return int(torch.argmax(logits[0]))
        time.sleep(0.002)
        return None

    eng = Engine(two_pod_cells(), runner=runner, heartbeat_timeout=1e9,
                 device=dev)
    eng.deploy(args.arch, ["pod0-cell0", "pod0-cell1", "pod1-cell0"],
               weights_gb=8)
    if args.with_train_tenant:
        eng.submit(Request(model="", kind="train"))

    rng = random.Random(args.seed)
    sessions = [f"s{i}" for i in range(args.sessions)]
    for s in sessions:
        eng.submit(Request(model=args.arch, kind="prefill", session=s))

    lat = []
    for i in range(args.requests):
        if i == args.fail_cell_at:
            victim = eng.session_cell(sessions[0])
            print(f"!! failing cell {victim}")
            eng.fail_cell(victim)
        s = rng.choice(sessions)
        c = eng.submit(Request(model=args.arch, kind="decode", session=s))
        if not c.ok:
            raise RuntimeError(f"decode not placed: {c}")
        lat.append(c.latency)
    print(f"{args.requests} decodes over {args.sessions} sessions: "
          f"mean {statistics.mean(lat)*1e3:.2f}ms p95 "
          f"{sorted(lat)[int(0.95*len(lat))]*1e3:.2f}ms; "
          f"relocations={len(eng.relocations)}")


if __name__ == "__main__":
    main()
