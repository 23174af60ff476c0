"""Faults planted underneath the timed path, each a way a prefill cell can
be wrong; ``plant(name, mp)`` sets one with a ``pytest.MonkeyPatch``.

* ``layer``: a step that returns its state unchanged: the last layer
  gives back its input;
* ``half``: half of the batch left out: the prefill sees only the
  prompt's second half (B = 1, so the half is of the tokens);
* ``answer``: an answer altered where it is produced: the served logits
  put the least likely token first;
* ``placement``: the scheduler places every prefill on ``pod0-cell0``,
  the train tenant's cell.

There is no exchange between chips to leave out: every cell takes one."""


def _layer(mp):
    from repro_torch.models import transformer

    real, real_forward, last = transformer._apply_layer, \
        transformer.lm_forward, [None]

    def skip_last(cfg, layer, x, *a):
        return x if layer is not None and layer is last[0] else real(
            cfg, layer, x, *a)

    def forward(cfg, model, batch, **kw):
        last[0] = model.layers[-1]
        return real_forward(cfg, model, batch, **kw)

    mp.setattr(transformer, "_apply_layer", skip_last)
    mp.setattr(transformer, "lm_forward", forward)


def _wrap_prefill(mp, wrap):
    from repro_torch.train import step

    real = step.make_prefill_step

    def make(cfg, **kw):
        return wrap(real(cfg, **kw))

    mp.setattr(step, "make_prefill_step", make)


def _half(mp):
    def wrap(inner):
        def prefill(model, batch):
            t = batch["tokens"]
            return inner(model, {"tokens": t[:, t.shape[1] // 2:]})
        return prefill

    _wrap_prefill(mp, wrap)


def _answer(mp):
    def wrap(inner):
        def prefill(model, batch):
            logits = inner(model, batch)
            worst = logits.argmin(-1, keepdim=True)
            return logits.scatter(-1, worst, logits.amax(-1, keepdim=True)
                                  + 1.0)
        return prefill

    _wrap_prefill(mp, wrap)


def _placement(mp):
    from repro_torch.core.batched import SchedulerSession
    from repro_torch.core.sharded import ShardedSession

    for cls in (SchedulerSession, ShardedSession):
        real = cls.try_schedule

        def moved(self, f, *, _real=real, **kw):
            cell = _real(self, f, **kw)
            return "pod0-cell0" if f.startswith("prefill") else cell

        mp.setattr(cls, "try_schedule", moved)


FAULTS = {"layer": _layer, "half": _half, "answer": _answer,
          "placement": _placement}
#: the number each fault has to fail
CAUGHT_BY = {"layer": "logit_err", "half": "logit_err", "answer": "logit_err",
             "placement": "misplaced"}


def plant(name: str, mp) -> None:
    FAULTS[name](mp)
