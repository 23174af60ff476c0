"""The port's serving engine against the JAX package's, on the CPU.

Both engines stand on ``two_pod_cells()`` with the same deployment, the
same seeds and a shared fake clock; the port's decides on
``device="cpu"`` (the affinity kernels' plain versions).  A
prefill / decode / train sequence with a cell failure in the middle must
place every request on the same cell, relocate the same sessions, and,
with a runner that decodes on reduced gemma3-4b or reduced falcon-mamba-7b
(the reference's weights converted with ``model_params_from_jax``), produce
the same argmax tokens.  Placements and tokens are compared for equality;
the logits behind the tokens agree within 1e-4
(``tests/test_torch_models.py``, ``tests/test_torch_ssm.py``)."""
import dataclasses
import functools
import warnings

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.cluster.topology import two_pod_cells as jax_cells  # noqa: E402
from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.models import init_cache as jax_init_cache  # noqa: E402
from repro.models import model_decode_step as jax_decode  # noqa: E402
from repro.pool import WarmPool as JaxWarmPool  # noqa: E402
from repro.pool import make_policy as jax_make_policy  # noqa: E402
from repro.serve.engine import Engine as JaxEngine  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.train.step import make_prefill_step as jax_prefill  # noqa: E402
from repro_torch.cluster.topology import two_pod_cells  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.convert import model_params_from_jax  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models import init_cache, model_decode_step  # noqa: E402
from repro_torch.pool import WarmPool, make_policy  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from repro_torch.train.step import make_prefill_step  # noqa: E402
from test_torch_models import jax_params  # noqa: E402
from test_torch_ssm import ssm_params  # noqa: E402

ARCH = "gemma3-4b"
DEPLOY = ["pod0-cell0", "pod0-cell1", "pod1-cell0"]


def next_token(done) -> int:
    """The decode input: a fixed token schedule (the n-th decode reads
    token 37 n mod 512), so the argmax outputs vary from step to step."""
    return 37 * len(done) % 512


def jax_runner(cfg, params, clock):
    step = jax.jit(functools.partial(jax_decode, cfg))
    caches, done = {}, []

    def run(req, cell):
        clock[0] += 0.01
        if req.kind == "prefill":
            caches[(req.session, cell)] = jax_init_cache(cfg, 1, 64)
            return None
        if req.kind == "decode":
            key = (req.session, cell)
            if key not in caches:
                caches[key] = jax_init_cache(cfg, 1, 64)
            tok = jnp.full((1, 1), next_token(done), jnp.int32)
            logits, caches[key] = step(params, caches[key], tok)
            done.append(int(jnp.argmax(logits[0])))
            return done[-1]
        return None

    return run


def port_runner(cfg, model, clock):
    caches, done = {}, []

    def run(req, cell):
        clock[0] += 0.01
        if req.kind == "prefill":
            caches[(req.session, cell)] = init_cache(cfg, 1, 64,
                                                     device="cpu")
            return None
        if req.kind == "decode":
            key = (req.session, cell)
            if key not in caches:
                caches[key] = init_cache(cfg, 1, 64, device="cpu")
            tok = torch.full((1, 1), next_token(done), dtype=torch.long)
            with torch.no_grad():
                logits, caches[key] = model_decode_step(cfg, model,
                                                        caches[key], tok)
            done.append(int(torch.argmax(logits[0])))
            return done[-1]
        return None

    return run


def drive(engine_cls, request_cls, cells, runner, clock, arch=ARCH, **kw):
    """The sequence: deploy, a train stream, 4 sessions' prefills, 12
    decodes, the failure of session s0's cell, 8 more decodes, the train
    stream stopped, 2 decodes.  Returns every completion's (cell, ok,
    result), the relocations and the sessions' final cells."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        eng = engine_cls(cells, runner=runner, clock=lambda: clock[0],
                         heartbeat_timeout=1e9, seed=7, **kw)
    eng.deploy(arch, DEPLOY, weights_gb=8)
    train = eng.submit(request_cls(model="", kind="train"))
    sessions = [f"s{i}" for i in range(4)]
    for s in sessions:
        eng.submit(request_cls(model=arch, kind="prefill", session=s))
    order = np.random.default_rng(11).integers(0, 4, 22)
    for i, j in enumerate(order):
        if i == 12:
            eng.fail_cell(eng.session_cell("s0"))
        if i == 20:
            eng.stop(train.rid)
        eng.submit(request_cls(model=arch, kind="decode",
                               session=sessions[j]))
    return ([(c.cell, c.ok, c.result) for c in eng.completions],
            list(eng.relocations), [eng.session_cell(s) for s in sessions])


@functools.lru_cache(maxsize=None)
def gemma():
    over = dict(n_layers=7)  # one period and a one-layer tail
    jcfg = dataclasses.replace(JAX_ARCHS[ARCH].reduced(), **over)
    tcfg = dataclasses.replace(ARCHS[ARCH].reduced(), **over)
    tree = jax_params(jcfg, seed=0)
    model = model_params_from_jax(tcfg, tree, device="cpu")
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), model


def test_engine_places_relocates_and_decodes_as_the_reference():
    jcfg, tcfg, params, model = gemma()
    jclock, tclock = [0.0], [0.0]
    want = drive(JaxEngine, JaxRequest, jax_cells(),
                 jax_runner(jcfg, params, jclock), jclock)
    got = drive(Engine, Request, two_pod_cells(),
                port_runner(tcfg, model, tclock), tclock, device="cpu")
    assert got == want
    completions, relocations, homes = got
    assert all(ok for _, ok, _ in completions)
    assert relocations  # the failed cell held a session
    decodes = [r for _, _, r in completions if r is not None]
    assert len(decodes) == 22 and len(set(decodes)) > 1


def test_engine_serving_falcon_mamba_equals_the_reference():
    """The SSM path behind the engine: reduced falcon-mamba-7b (two mamba
    layers, float32) decoding through the conv / state caches."""
    arch = "falcon-mamba-7b"
    jcfg, tcfg = JAX_ARCHS[arch].reduced(), ARCHS[arch].reduced()
    tree = ssm_params(jcfg, seed=0)
    model = model_params_from_jax(tcfg, tree, device="cpu")
    params = jax.tree.map(jnp.asarray, tree)
    jclock, tclock = [0.0], [0.0]
    want = drive(JaxEngine, JaxRequest, jax_cells(),
                 jax_runner(jcfg, params, jclock), jclock, arch=arch)
    got = drive(Engine, Request, two_pod_cells(),
                port_runner(tcfg, model, tclock), tclock, arch=arch,
                device="cpu")
    assert got == want
    completions, relocations, homes = got
    assert all(ok for _, ok, _ in completions) and relocations
    decodes = [r for _, _, r in completions if r is not None]
    assert len(decodes) == 22 and len(set(decodes)) > 1


def test_engine_with_a_warm_pool_equals_the_reference():
    """The copied pool: container starts charged, ``warm:<fn>`` residency
    tags published, warmth ranks passed to the scheduler."""
    def pool(cls, policy):
        return cls(policy("fixed_ttl", ttl=0.05))

    jclock, tclock = [0.0], [0.0]
    noop = lambda clock: (lambda req, cell: clock.__setitem__(  # noqa: E731
        0, clock[0] + 0.01))
    jpool = pool(JaxWarmPool, jax_make_policy)
    tpool = pool(WarmPool, make_policy)
    want = drive(JaxEngine, JaxRequest, jax_cells(), noop(jclock), jclock,
                 pool=jpool)
    got = drive(Engine, Request, two_pod_cells(), noop(tclock), tclock,
                pool=tpool, device="cpu")
    assert got == want
    assert tpool.metrics.snapshot() == jpool.metrics.snapshot()


def vlm_prompt(cfg, session: str):
    """A session's seeded prompt: n_patches patch features and text tokens,
    320 positions in all (over 256 x 256, so attention takes its chunked
    or flash path, not the direct one)."""
    rng = np.random.default_rng(int(session[1:]))
    return {"patches": rng.standard_normal(
                (1, cfg.n_patches, cfg.frontend_dim), dtype=np.float32),
            "tokens": rng.integers(0, cfg.vocab,
                                   (1, 320 - cfg.n_patches)).astype(np.int32)}


def vlm_runner(prefill, decode, clock, seen):
    """``decode`` (a runner as above) for decodes; a prefill runs
    ``prefill`` on the session's prompt, keeps its logits in ``seen`` and
    returns their argmax."""
    def run(req, cell):
        if req.kind != "prefill":
            return decode(req, cell)
        clock[0] += 0.01
        logits = np.asarray(prefill(req.session))
        seen.append(logits)
        decode(req, cell)  # the session's (empty) decode cache
        return int(np.argmax(logits[0]))

    return run


def test_engine_serving_internvl2_with_patches_equals_the_reference():
    """The vlm path behind the engine: reduced internvl2-76b prefills its
    sessions' patches and text (the reference's default chunked attention,
    the port's flash path on the CPU), then decodes; the prefill logits
    within 1e-4, the placements and tokens equal."""
    arch = "internvl2-76b"
    jcfg, tcfg = JAX_ARCHS[arch].reduced(), ARCHS[arch].reduced()
    tree = jax_params(jcfg, seed=2)
    model = model_params_from_jax(tcfg, tree, device="cpu")
    params = jax.tree.map(jnp.asarray, tree)
    jpre, tpre = jax_prefill(jcfg), make_prefill_step(tcfg, impl="flash")

    def jax_prompt(session):
        return jpre(params, jax.tree.map(jnp.asarray,
                                         vlm_prompt(tcfg, session)))

    def port_prompt(session):
        b = vlm_prompt(tcfg, session)
        return tpre(model, {"patches": torch.from_numpy(b["patches"]),
                            "tokens": torch.from_numpy(b["tokens"]).long()})

    jclock, tclock, jseen, tseen = [0.0], [0.0], [], []
    want = drive(JaxEngine, JaxRequest, jax_cells(),
                 vlm_runner(jax_prompt, jax_runner(jcfg, params, jclock),
                            jclock, jseen), jclock, arch=arch)
    got = drive(Engine, Request, two_pod_cells(),
                vlm_runner(port_prompt, port_runner(tcfg, model, tclock),
                           tclock, tseen), tclock, arch=arch, device="cpu")
    assert got == want
    completions, relocations, _ = got
    assert all(ok for _, ok, _ in completions) and relocations
    assert len(tseen) == len(jseen) > 4  # the failed cell's re-prefilled
    for a, b in zip(jseen, tseen):
        assert a.shape == b.shape == (1, tcfg.vocab)
        assert float(np.max(np.abs(a - b))) < 1e-4


def test_the_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Engine(two_pod_cells())


def test_launch_serve_runs_on_the_cpu(capsys):
    port_serve.main(["--device", "cpu", "--requests", "12", "--sessions",
                     "3", "--fail-cell-at", "6", "--with-train-tenant"])
    out = capsys.readouterr().out
    assert "12 decodes over 3 sessions" in out and "failing cell" in out


def test_launch_serve_runs_falcon_mamba_on_the_cpu(capsys):
    port_serve.main(["--arch", "falcon-mamba-7b", "--device", "cpu",
                     "--requests", "10", "--sessions", "3", "--fail-cell-at",
                     "4"])
    out = capsys.readouterr().out
    assert "10 decodes over 3 sessions" in out and "failing cell" in out
    assert "relocations=" in out and "relocations=0" not in out
