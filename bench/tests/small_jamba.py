"""A small jamba2-mini-16l for runs on the CPU, and the faults a
comparison of it has to catch.

The small configuration keeps the full one's layout: two periods of eight
layers with the attention at position 4, experts on the odd layers
(dropless top-2, the weights not divided by their sum), the Mamba blocks'
norms on dt, B and C, and no positional encoding; its widths are a test's,
served in float32 unless asked otherwise.

The faults, each planted underneath the timed path with a
``pytest.MonkeyPatch`` (``plant(name, mp)``):

* ``renorm``: the top-2 weights divided by their sum (the port's GShard
  convention, not Jamba's);
* ``rope``: RoPE applied to q and k in the attention layers;
* ``inner_norms``: the RMS norms on dt, B and C left out;
* ``layer``: the last layer returning its input (as ``faults.py``'s, but
  the layer is held by a weak reference, so that a model of 52 GB goes
  with its run).

At the full size on the card, ``renorm`` and ``inner_norms`` read far
above the program's ``logit_err``; ``rope`` and ``layer`` read within its
own range there (the readings are in PERF.md)."""
import copy
import dataclasses
import weakref

from bench.harness import spec

NAME = "jamba2-mini-16l"
CELL = {"name": f"{NAME}.prefill", "config": NAME, "traffic": "prefill",
        "chips": 1}
SMALL = {"hidden_size": 64, "num_attention_heads": 4,
         "num_key_value_heads": 2, "intermediate_size": 32,
         "num_experts": 4, "mamba_d_state": 4, "mamba_dt_rank": 8,
         "vocab_size": 512}
PORT = {"d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
        "d_ff": 32, "vocab": 512}


def config(dtype: str = "float32") -> dict:
    """The configuration file's dict at the small widths."""
    cfg = copy.deepcopy(spec.config(NAME))
    cfg.update(SMALL, torch_dtype=dtype)
    rep = cfg["port"]["replace"]
    rep.update(PORT, dtype=dtype)
    rep["ssm"].update(d_state=4, dt_rank=8)
    rep["moe"].update(n_experts=4, d_ff_expert=32)
    return cfg


def _renorm(mp):
    from repro_torch.models import moe

    real = moe.route_dropless

    def renormed(m, xf, s):
        top_p, top_i = real(m, xf, s)
        return top_p / top_p.sum(-1, keepdim=True), top_i

    mp.setattr(moe, "route_dropless", renormed)


def _rope(mp):
    from repro_torch.models import transformer

    real = transformer._rotate
    mp.setattr(transformer, "_rotate", lambda cfg, kind, q, k, pos: real(
        dataclasses.replace(cfg, pos_emb="rope"), kind, q, k, pos))


def _inner_norms(mp):
    from repro_torch.models import ssm

    mp.setattr(ssm, "_inner_norms", lambda m, s, dt, b, c: (dt, b, c))


def _layer(mp):
    from repro_torch.models import transformer

    real, real_forward = transformer._apply_layer, transformer.lm_forward
    last = [lambda: None]

    def skip_last(cfg, layer, x, *a):
        return x if layer is last[0]() else real(cfg, layer, x, *a)

    def forward(cfg, model, batch, **kw):
        last[0] = weakref.ref(model.layers[-1])
        return real_forward(cfg, model, batch, **kw)

    mp.setattr(transformer, "_apply_layer", skip_last)
    mp.setattr(transformer, "lm_forward", forward)


FAULTS = {"renorm": _renorm, "rope": _rope, "inner_norms": _inner_norms,
          "layer": _layer}


def plant(name: str, mp) -> None:
    FAULTS[name](mp)
