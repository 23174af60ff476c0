"""Entry kind ``prefill``: the port's serving engine in front of one model,
driven by one closed-loop client with prompts of the mix's lengths.

Set-up: the weights are drawn on the card from the seed (``harness/
weights.py``, the reference family's leaves) and handed to the port's
model; ``serve.Engine`` stands up over the deployment's cells with the
model resident on ``model_cells`` and a train tenant; one prefill at the
mix's longest and one at its shortest length warm every path.

The window: request i is a new turn of session ``s<i mod sessions>`` with
fresh token ids drawn on the card from the seed; the client submits it
through ``Engine.submit`` and sends the next when it returns.  The engine
places it by its synthesised Listing-1 policy (``affinity_valid`` on the
card) and calls the runner, which runs the port's prefill step
(``train.step.make_prefill_step(cfg, impl="flash")``: attention through the
bf16 flash kernel, mamba layers through the selective-scan kernel) and
brings the last position's logits to the host, as a first token needs.
The window closes at the first completion after ``seconds``.

Then the check: a sample of the finished requests (the longest and the
shortest among them) against the plain reference, and every placement
against the policy's admitted cells.
"""
from __future__ import annotations

import dataclasses
import math
import time
import warnings

from bench.harness import traffic as tr
from bench.harness.weights import Weights
from bench.reference import placement


@dataclasses.dataclass
class Record:
    index: int
    session: str
    length: int
    t_submit: float
    t_done: float
    latency: float  # the runner's own seconds, as the engine measured them
    ok: bool
    cell: str
    logits: object = None  # float32 on the host
    profiled: bool = False

    @property
    def wall(self) -> float:
        return self.t_done - self.t_submit


def port_config(cfg: dict):
    """The port's configuration: its registry entry with the file's
    ``port.replace`` applied (a dict for a nested spec replaces its
    fields)."""
    from repro_torch.configs import get_arch

    base = get_arch(cfg["port"]["registry"])
    changes = {}
    for key, value in cfg["port"].get("replace", {}).items():
        old = getattr(base, key)
        changes[key] = (dataclasses.replace(old, **value)
                        if dataclasses.is_dataclass(old) and
                        isinstance(value, dict) else value)
    return dataclasses.replace(base, **changes)


def load_model(port_cfg, weights: Weights):
    """The port's model with the benchmark's weights in place: every
    parameter of its layout is a leaf of the same shape and type (a
    zero-size one, such as a zero-width FFN's, is an empty tensor)."""
    import torch
    from repro_torch.models import params_shape

    model = params_shape(port_cfg)
    state = weights.state_dict()
    for name, p in model.named_parameters():
        if name not in state and p.numel() == 0:
            state[name] = torch.empty(p.shape, dtype=p.dtype,
                                      device=weights.buffers[
                                          next(iter(weights.buffers))].device)
        got = state.get(name)
        if got is None or got.shape != p.shape or got.dtype != p.dtype:
            raise ValueError(f"the port's parameter {name} {tuple(p.shape)} "
                             f"{p.dtype} has no leaf of that shape and type "
                             f"({None if got is None else (tuple(got.shape), got.dtype)})")
    model.load_state_dict(state, strict=True, assign=True)
    return model


class Runner:
    """What the engine calls for each request: a prefill runs the port's
    prefill step and brings the last position's logits to the host."""

    def __init__(self, port_cfg, model):
        import torch
        from repro_torch.train.step import make_prefill_step

        self.torch = torch
        self.model = model
        self.step = make_prefill_step(port_cfg, impl="flash")
        self.logits = None

    def __call__(self, req, cell):
        if req.kind != "prefill":
            return None  # the train tenant: placed, held, never run here
        rf = self.torch.autograd.profiler.record_function
        with rf("bench.prefill_step"):
            out = self.step(self.model, {"tokens": req.payload})
        with rf("bench.logits_to_host"):
            self.logits = out[0].to("cpu")
        return int(self.logits.argmax())


def draw_tokens(torch, seed: int, purpose: str, i: int, length: int,
                vocab: int, device):
    g = torch.Generator(device=device).manual_seed(tr.sub_seed(seed, purpose,
                                                               i))
    return torch.randint(0, vocab, (1, length), generator=g, device=device)


def run(ctx) -> dict:
    """Set up, warm up, run the window, check it.  ``ctx`` carries the
    cell, its configuration and mix, the seed, the window's seconds, whether
    to trace, the device and the process's start; returns what the harness
    needs for the result."""
    import torch
    from repro_torch.cluster.topology import two_pod_cells
    from repro_torch.serve.engine import Engine, Request

    from bench.harness import trace as tracing

    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    family = ctx.family
    dep = mix["deployment"]
    name = cfg["name"]
    vocab = cfg["vocab_size"]
    port_cfg = port_config(cfg)

    log = ctx.log
    log("set-up: torch, the port and the card ready")
    weights = Weights(family.leaves(cfg), tr.sub_seed(ctx.seed, "weights"),
                      dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    log(f"set-up: weights drawn ({weights.nbytes() / 1e9:.3f} GB)")
    model = load_model(port_cfg, weights)
    runner = Runner(port_cfg, model)
    cells = two_pod_cells(cells_per_pod=dep["cells_per_pod"],
                          chips_per_cell=dep["chips_per_cell"],
                          hbm_per_chip_gb=dep["hbm_per_chip_gb"])
    want = [(f"{p}-cell{j}", p, dep["chips_per_cell"] * dep["hbm_per_chip_gb"])
            for p in dep["pods"] for j in range(dep["cells_per_pod"])]
    if [(n, c.zone, c.hbm_gb) for n, c in cells.items()] != want:
        raise ValueError(f"the topology's cells are not the deployment's "
                         f"{want}")
    with warnings.catch_warnings():  # the v1 call shape, as launch/serve.py
        warnings.simplefilter("ignore", DeprecationWarning)
        eng = Engine(cells, runner=runner, heartbeat_timeout=1e9,
                     device=dev)
    eng.deploy(name, list(dep["model_cells"]), weights_gb=dep["weights_gb"],
               kv_gb_per_session=dep["kv_gb_per_session"],
               req_gb=dep["req_gb"])
    log("set-up: model loaded, engine deployed")
    placements = []
    if dep.get("train_tenant"):
        c = eng.submit(Request(model="", kind="train"))
        placements.append(("train", None, c.cell))

    def submit(tokens, session):
        with torch.autograd.profiler.record_function("bench.submit"):
            return eng.submit(Request(model=name, kind="prefill",
                                      session=session, payload=tokens))

    for j, length in enumerate(tr.warmup_lengths(mix)):
        session = tr.session_of(mix, j)
        c = submit(draw_tokens(torch, ctx.seed, "warmup", j, length, vocab,
                               dev), session)
        placements.append(("prefill", session, c.cell))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.t_start
    log("set-up: warm-up prefills done; the window opens")

    def serve(i, profiled=False):
        length, session = tr.length_of(mix, i), tr.session_of(mix, i)
        with torch.autograd.profiler.record_function("bench.draw_tokens"):
            tokens = draw_tokens(torch, ctx.seed, "tokens", i, length, vocab,
                                 dev)
        t_s = time.perf_counter()
        c = submit(tokens, session)
        t_d = time.perf_counter()
        ok = bool(c.ok) and runner.logits is not None
        rec = Record(i, session, length, t_s, t_d, c.latency, ok, c.cell,
                     logits=runner.logits if ok else None, profiled=profiled)
        runner.logits = None
        placements.append(("prefill", session, c.cell))
        return rec

    records = [serve(0)]
    while records[-1].t_done - records[0].t_submit < ctx.seconds:
        records.append(serve(len(records)))
    log(f"window: {len(records)} requests in "
            f"{records[-1].t_done - records[0].t_submit:.3f} s; ms each: "
            + " ".join(f"{r.length}:{r.wall * 1e3:.1f}" for r in records))
    summary = None
    if ctx.trace:  # after the window, the cycle going on: every length once
        with tracing.Span() as span:
            for _ in range(mix["profile"]["requests"]):
                records.append(serve(len(records), profiled=True))
        summary = span.summary
        summary.requests = [r.index for r in records if r.profiled]

    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    # the program goes before the reference runs; the weights are the
    # benchmark's inputs
    del eng, runner, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = check(ctx, weights, records, placements)
    return {"records": records, "setup_s": setup_s, "memory_peak_bytes": peak,
            "trace": summary,
            "checks": checks}


def check(ctx, weights, records, placements) -> dict:
    """The numbers ``correct`` compares, each with its value and limit:

    * ``logit_err``: over the compared requests, the largest RMS of the
      served logits' difference from the reference's, over the RMS of the
      reference's;
    * ``misplaced``: placements outside the cells the policy admits;
    * ``unserved``: window requests that failed or gave a non-finite
      logit.

    The reference works every request out again from the benchmark's
    weights and token ids alone: it routes a mixture of experts by its own
    float32 router.  With ``ctx.control`` (the calibration and the card's
    tests, never a benchmark run) ``logit_err`` also carries the control's
    reading: the reference in fp8 (``reference/common.py``) in the
    program's place, on the same prompts.
    """
    import torch

    from bench.reference.common import exact_float32

    cfg, mix, fam = ctx.config, ctx.mix, ctx.family
    unserved = sum(1 for r in records if not r.ok or
                   not bool(torch.isfinite(r.logits).all()))
    done = [r for r in records if r.ok]
    picked = tr.compared([r.length for r in done],
                         mix["compare"]["requests"], ctx.seed)
    exact_float32()
    t0 = time.perf_counter()
    values = {"logit_err": 0.0 if picked else math.inf}
    control = {}

    def rel(a, b):
        return float((a - b).square().mean().sqrt()) / float(
            b.square().mean().sqrt())

    def worst(into, numbers):
        for k, v in numbers.items():
            into[k] = max(into.get(k, -math.inf), v)

    for k in picked:
        r = done[k]
        tokens = draw_tokens(torch, ctx.seed, "tokens", r.index, r.length,
                             cfg["vocab_size"], ctx.device)
        ref = fam.last_logits(cfg, weights, tokens[0], "float32").cpu()
        numbers = {"logit_err": rel(r.logits.float(), ref)}
        worst(values, numbers)
        line = f"check: request {r.index} ({r.length} tokens): {numbers}"
        if ctx.control:  # the reference one precision down, in its place
            low = fam.last_logits(cfg, weights, tokens[0], "fp8").cpu()
            c = {"logit_err": rel(low, ref)}
            worst(control, c)
            line += f"; control {c}"
        ctx.log(line)
    ctx.log(f"check: the reference over {len(picked)} requests "
            f"({[done[k].length for k in picked]} tokens) took "
            f"{time.perf_counter() - t0:.2f} s")
    bad = placement.misplaced(mix["deployment"], cfg["name"], placements)
    values.update(misplaced=float(len(bad)), unserved=float(unserved))
    out = {k: {"value": float(v), "limit": ctx.limits[k]}
           for k, v in values.items()}
    for k, v in control.items():
        out[k]["control"] = float(v)
    return out
