"""The plain reference against the port's plain path on the CPU, at
small sizes of both families (float32 on both sides, so they agree to
rounding), and the placement reference against the engine's choices."""
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", 1))))

from bench.entries import prefill  # noqa: E402
from bench.harness import spec  # noqa: E402
from bench.harness import traffic as tr  # noqa: E402
from bench.harness.weights import Weights  # noqa: E402
from bench.reference import placement  # noqa: E402
from bench.tests import small  # noqa: E402

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", ["falcon-mamba-7b", "qwen3-moe-30b-a3b"])
@pytest.mark.parametrize("S", [1, 37, 70])
def test_reference_matches_the_ports_plain_path(name, S):
    cfg = small.config(name)
    fam = spec.reference(cfg["reference"])
    port_cfg = prefill.port_config(cfg)
    w = Weights(fam.leaves(cfg), seed=S, device=CPU)
    model = prefill.load_model(port_cfg, w)
    step = prefill.Runner(port_cfg, model).step
    tokens = torch.randint(0, cfg["vocab_size"], (S,),
                           generator=torch.Generator().manual_seed(S))
    got = step(model, {"tokens": tokens[None]})[0]
    want = fam.last_logits(cfg, w, tokens)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4 * float(
        want.abs().max()))


def test_moe_reference_drops_past_capacity_as_the_port_does():
    """A group of 16 tokens over 4 experts at top-2 has capacity 12
    (int(2 x 16 / 4 x 1.25) = 10, up to a multiple of 4); zero rows all
    pick experts 0 and 1, so their later choices are dropped."""
    cfg = small.config("qwen3-moe-30b-a3b")
    fam = spec.reference(cfg["reference"])
    assert fam.capacity(cfg, 16) == 12
    xg = torch.zeros((1, 16, cfg["hidden_size"]))
    router = torch.randn((cfg["hidden_size"], 4))
    top_i, w, kept = fam.route(cfg, xg, router, "float32")
    assert top_i[0, :, 0].eq(0).all() and top_i[0, :, 1].eq(1).all()
    assert kept[0, :12].all() and not kept[0, 12:].any()
    assert torch.allclose(w, torch.full_like(w, 0.5))


def test_weights_follow_the_seed_and_their_inits():
    cfg = small.config("falcon-mamba-7b")
    fam = spec.reference(cfg["reference"])
    a = Weights(fam.leaves(cfg), seed=5, device=CPU)
    b = Weights(fam.leaves(cfg), seed=5, device=CPU)
    c = Weights(fam.leaves(cfg), seed=6, device=CPU)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["lm_head"], sc["lm_head"])
    assert torch.equal(sa["layers.1.ssm.a_log"][3], torch.log(
        torch.arange(1, cfg["state_size"] + 1, dtype=torch.float32)))
    assert torch.equal(sa["layers.0.ln2.w"], torch.ones(cfg["hidden_size"]))
    dt = torch.nn.functional.softplus(sa["layers.0.ssm.dt_b"].float())
    assert float(dt.min()) >= 0.99 * cfg["time_step_min"]
    assert float(dt.max()) <= 1.01 * cfg["time_step_max"]


def test_placement_reference_agrees_with_the_engine():
    from repro_torch.cluster.topology import two_pod_cells
    from repro_torch.serve.engine import Engine, Request

    mix = spec.traffic("prefill")
    dep = mix["deployment"]
    eng = Engine(two_pod_cells(), heartbeat_timeout=1e9, device="cpu")
    eng.deploy("m", dep["model_cells"], weights_gb=dep["weights_gb"],
               kv_gb_per_session=dep["kv_gb_per_session"],
               req_gb=dep["req_gb"])
    got = [("train", None, eng.submit(Request(model="", kind="train")).cell)]
    for i in range(70):
        s = tr.session_of(mix, i)
        got.append(("prefill", s, eng.submit(
            Request(model="m", kind="prefill", session=s)).cell))
    assert placement.misplaced(dep, "m", got) == []
    cl = placement.Cluster(dep, "m")
    cl.hold(got[0][2], dep["req_gb"], "train")
    admitted = cl.admitted(cl.prefill_blocks())
    assert got[0][2] not in admitted and set(admitted) < set(
        dep["model_cells"])
    # a prefill on the train tenant's cell, or off the model's cells, is
    # misplaced
    assert placement.misplaced(dep, "m", got[:3] + [
        ("prefill", "s9", got[0][2]), ("prefill", "s9", "pod1-cell3")]) \
        == [3, 4]
