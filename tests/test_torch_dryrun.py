"""The port's dry run (``python -m repro_torch.launch.dryrun``) against the
reference's, on the CPU, as subprocesses on fake ranks.

The cells are ``tests/test_system.py``'s, reduced, with ``--mesh both`` on
8 fake ranks ((2, 2) and (2, 2, 2)), and starcoder2-15b's long_500k skip.
The reference's dry run runs on its single (2, 2) mesh of 4 host devices
with the mesh axes ``Auto``, the default of the jax it was written for
(jax 0.9's ``jax.make_mesh`` makes them ``Explicit``, under which its
embedding gather raises ``ShardingTypeError``: the three known
``test_system.py`` failures); its record and the matrix-product flops of
its partitioned HLO come back as JSON.

On the single mesh the port's record equals the reference's in status,
``fsdp``, the parameter counts, the model flops per device and the
per-device argument bytes; the matrix-product flops per device agree
within 1% (the chunked loss and the attention's backward are formed in
another order of products, nothing else).  The total flops, bytes,
collectives and the other memory keys are printed, not held: XLA fuses,
DTensor picks other collectives than GSPMD, and XLA's CPU backend reports
a peak near the arguments beside the sum of its temporary buffers.  Each
port record carries the reference's memory keys, counted through the
step on the local shards.  The multi-pod leg, which the reference cannot run
under jax 0.9, runs on the port.
"""
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# torch's intra-op threads: this pytest-xdist worker's share of the cores
torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", 1))))

pytest.importorskip("jax")  # the reference's dry run needs a real JAX

ROOT = Path(__file__).resolve().parent.parent
CELLS = [("gemma3-4b", "train_4k"), ("jamba-1.5-large-398b", "decode_32k"),
         ("qwen3-moe-30b-a3b", "prefill_32k")]
SAME = ("status", "fsdp", "params_total", "params_active",
        "model_flops_per_device")
PRODUCT_REL = 0.01

#: how each subprocess starts: at the lowest priority (see WIDTH), then
#: the module named first among its arguments, as ``python -m``
NICE = ("import os, runpy, sys; os.nice(19); sys.argv = sys.argv[1:]; "
        "runpy.run_module(sys.argv[0], run_name='__main__', alter_sys=True)")

REFERENCE = textwrap.dedent('''
    import json, os, sys
    os.nice(19)
    os.environ["REPRO_DRYRUN_DEVICES"] = "4"
    import repro.launch.dryrun as d  # sets XLA_FLAGS before jax
    # one compute thread: the test runs beside the suite's other workers
    os.environ["XLA_FLAGS"] += " --xla_cpu_multi_thread_eigen=false"
    import jax
    from repro.roofline import flops as F

    make_mesh = jax.make_mesh
    jax.make_mesh = lambda shape, axes, **kw: make_mesh(
        shape, axes, axis_types=(jax.sharding.AxisType.Auto,) * len(axes),
        **kw)
    texts = []
    analyze = d.hlo_flops.analyze
    d.hlo_flops.analyze = lambda t: (texts.append(t), analyze(t))[1]
    rec = d.run_cell(sys.argv[1], sys.argv[2], False, reduced=True)

    def dot_flops(text):
        """analyze()'s dot rule alone, loop-aware."""
        blocks, _ = F._parse_blocks(text)
        mult = F.computation_multiplicities(text)
        tot = 0.0
        for name, lines in blocks.items():
            shapes = {}
            for line in lines:
                dm = F._DEF_RE.match(line)
                if not dm:
                    continue
                nm, shape, op = dm.groups()
                shapes[nm] = shape
                if op != "dot" or mult.get(name, 0.0) <= 0:
                    continue
                lc = F._LHS_C_RE.search(line)
                ops = F._OPERANDS_RE.findall(line.split("dot(", 1)[1])
                dims = F._shape_dims(shapes.get(ops[0], ""))
                k = 1
                for i in (int(x) for x in lc.group(1).split(",") if x):
                    k *= dims[i]
                tot += mult[name] * 2.0 * F._shape_elems(shape) * k
        return tot

    rec["product_flops_per_device"] = dot_flops(texts[0]) if texts else 0
    print("RECORD " + json.dumps(rec, default=float))
''')


#: subprocesses at a time, each on one compute thread at the lowest
#: priority: the suite's other workers run beside this file, and their
#: multi-threaded torch ops slow by orders of magnitude on a core that
#: another busy process takes from them
WIDTH = 2


def _run_all(jobs: dict, out: Path, env) -> dict:
    """Run ``{key: (args, log name)}``, WIDTH at a time, in the order
    given; returns ``{key: return code}``."""
    todo, running, done = list(jobs.items()), {}, {}
    deadline = time.monotonic() + 1200
    while todo or running:
        while todo and len(running) < WIDTH:
            key, (args, log) = todo.pop(0)
            with open(out / log, "w") as f:
                running[key] = subprocess.Popen(
                    [sys.executable, *args], cwd=ROOT, env=env, stdout=f,
                    stderr=subprocess.STDOUT)
        for key, p in list(running.items()):
            if p.poll() is not None:
                done[key] = running.pop(key).returncode
        if time.monotonic() > deadline:
            for p in running.values():
                p.kill()
            raise TimeoutError(f"dry runs still running: {list(running)}")
        time.sleep(0.2)
    return done


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's dry run of each cell on both meshes and of the skip, the
    reference's single-mesh run of each cell, longest first, their output
    in ``<key>.log`` files.  Returns the output directory and ``{key:
    return code}``."""
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", REPRO_DRYRUN_DEVICES="8",
               OMP_NUM_THREADS="1")
    port = ["-c", NICE, "repro_torch.launch.dryrun", "--reduced",
            "--device", "cpu", "--out", str(out)]
    jobs = {("port", arch): (port + ["--arch", arch, "--shape", shape,
                                     "--mesh", "both"], f"port_{arch}.log")
            for arch, shape in CELLS}
    jobs.update({("ref", arch): (["-c", REFERENCE, arch, shape],
                                 f"ref_{arch}.log") for arch, shape in CELLS})
    jobs[("skip",)] = (port + ["--arch", "starcoder2-15b", "--shape",
                               "long_500k"], "skip.log")
    return out, _run_all(jobs, out, env)


def _log(out: Path, name: str) -> str:
    return (out / name).read_text()


def record(out: Path, arch: str, shape: str, mesh: str) -> dict:
    return json.loads((out / f"{arch}_{shape}_{mesh}.json").read_text())


@pytest.mark.parametrize("arch,shape", CELLS)
def test_the_single_mesh_record_equals_the_reference(runs, arch, shape):
    out, _ = runs
    ref_log = _log(out, f"ref_{arch}.log")
    assert "RECORD " in ref_log, ref_log[-3000:]
    want = json.loads(ref_log.split("RECORD ", 1)[1].splitlines()[0])
    got = record(out, arch, shape, "single")
    assert got["status"] == "ok", got.get("traceback", got)[-3000:]
    assert got["mesh"] == "2x2" and got["n_chips"] == 4
    assert {k: got[k] for k in SAME} == {k: want[k] for k in SAME}
    assert got["memory"]["argument_bytes"] == \
        want["memory"]["argument_bytes"]
    p, r = (got["loop_aware"]["product_flops_per_device"],
            want["product_flops_per_device"])
    print(f"{arch} {shape}: product flops per device {p} (reference {r}, "
          f"{p / r - 1:+.4%}); flops {got['loop_aware']['flops_per_device']}"
          f" (reference {want['loop_aware']['flops_per_device']}); bytes "
          f"{got['loop_aware']['bytes_per_device']} (reference "
          f"{want['loop_aware']['bytes_per_device']}); collectives "
          f"{got['collectives']} (reference {want['collectives']}); memory "
          f"{got['memory']} (reference {want['memory']})")
    assert abs(p - r) <= PRODUCT_REL * r


@pytest.mark.parametrize("arch,shape", CELLS)
def test_the_multi_pod_leg_runs_on_the_port(runs, arch, shape):
    out, done = runs
    assert done[("port", arch)] == 0, _log(out, f"port_{arch}.log")[-3000:]
    rec = record(out, arch, shape, "multi")
    assert rec["status"] == "ok" and rec["mesh"] == "2x2x2"
    assert rec["n_chips"] == 8 and rec["loop_aware"]["flops_per_device"] > 0
    r = rec["roofline"]
    assert min(r["compute_s"], r["memory_s"], r["collective_s"]) >= 0
    assert r["dominant"] in ("compute", "memory", "collective")
    single = record(out, arch, shape, "single")
    # the pod axis halves each device's share of the batch again
    assert rec["memory"]["argument_bytes"] < \
        single["memory"]["argument_bytes"]
    print(f"{arch} {shape} multi: {json.dumps(r)}, collectives "
          f"{rec['collectives']}, link bytes by axis "
          f"{rec['collective_link_bytes_by_axis']}")


MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes",
          "alias_bytes"}


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_the_record_counts_each_devices_memory(runs, arch, shape, mesh):
    """The reference's memory keys, counted on the local shards through the
    step (no stand-in: no ``peak_why``, no ``xla_cost``): the peak holds
    the arguments, the temporaries are the rest of it; a train step writes
    its parameters and moments in place, a prefill writes no argument, and
    jamba's decode step writes its attention layers' KV cache."""
    out, _ = runs
    rec = record(out, arch, shape, mesh)
    assert rec["status"] == "ok", rec.get("traceback", rec)[-3000:]
    mem = rec["memory"]
    assert set(mem) == MEMORY and "xla_cost" not in rec
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
    assert mem["output_bytes"] > 0
    assert mem["temp_bytes"] == max(0, mem["peak_bytes"]
                                    - mem["argument_bytes"]
                                    - mem["output_bytes"])
    assert (mem["alias_bytes"] > 0) == (rec["kind"] != "prefill")
    assert mem["alias_bytes"] <= mem["argument_bytes"]
    print(f"{arch} {shape} {rec['mesh']}: {mem}")


def test_the_peak_probe_finds_the_records_peak():
    """``tools/dryrun_peak.py`` on a narrow falcon-mamba prefill_32k cell:
    the record it prints, and a peak within 1% below the record's, most
    of it in the live bytes of the ten ops it lists."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_DRYRUN_DEVICES="8", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "dryrun_peak.py"),
         "falcon-mamba-7b", "prefill_32k", "--reduced", "--device", "cpu",
         "--set", "d_model=128", "--set", "n_layers=2", "--set",
         "scan_chunk=256"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    mem = json.loads(lines[0].split(": ", 1)[1])
    peak = float(lines[1].split("~", 1)[1].split(" GB")[0]) * 1e9
    assert 0.99 * mem["peak_bytes"] - 1e6 <= peak <= mem["peak_bytes"] + 1e6
    by_op = [float(x.rsplit(": ", 1)[1].split(" GB")[0]) * 1e9
             for x in lines if x.startswith("  made by ")]
    assert 0.9 * peak <= sum(by_op) <= peak + 1e7  # the ten largest ops


def test_the_dry_run_records_a_skip(runs):
    out, done = runs
    assert done[("skip",)] == 0
    rec = record(out, "starcoder2-15b", "long_500k", "single")
    assert rec["status"] == "skipped" and "500k" in rec["why"]


def test_the_mesh_module_holds_the_h100s_peaks_and_layout():
    from repro_torch.launch import mesh

    src = (ROOT / "src" / "repro_torch" / "launch" / "mesh.py").read_text()
    assert "197e12" not in src and "819e9" not in src and "ICI" not in src
    assert (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW, mesh.NVLINK_BW,
            mesh.IB_BW) == (989e12, 3.35e12, 450e9, 50e9)
    assert mesh.link_bw("model") == mesh.NVLINK_BW
    assert mesh.link_bw("data") == mesh.link_bw("pod") == mesh.IB_BW
