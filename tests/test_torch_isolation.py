"""The port stands alone: nothing under ``src/repro_torch/`` or in
``chip_smoke.py`` imports JAX or the JAX package (checked on the source and
on a fresh interpreter's ``sys.modules``), and nothing moves to the CPU on
its own — the default ``device="cuda"`` raises where there is no card."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_sources_import_neither_jax_nor_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_modules(f) if _forbidden(m)]
    assert bad == []


def test_a_fresh_interpreter_loads_no_jax_and_no_reference_module():
    code = (
        "import sys, json\n"
        "sys.path.insert(0, 'src'); sys.path.insert(0, '.')\n"
        "import repro_torch, repro_torch.core, repro_torch.platform, "
        "repro_torch.analysis, repro_torch.convert, "
        "repro_torch.kernels.affinity, repro_torch.configs, "
        "repro_torch.models, repro_torch.kernels.flash_attention, "
        "repro_torch.kernels.mamba_scan, repro_torch.models.ssm, "
        "repro_torch.train.step, repro_torch.serve.engine, repro_torch.pool, "
        "repro_torch.cluster.topology, repro_torch.launch.serve, "
        "repro_torch.forecast, repro_torch.models.moe, "
        "repro_torch.models.encdec, repro_torch.optim.adamw, "
        "repro_torch.optim.compress, repro_torch.checkpoint.manager, "
        "repro_torch.data.pipeline, repro_torch.launch.train, chip_smoke\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout
    import json
    mods = json.loads(out.strip().splitlines()[-1])
    assert [m for m in mods if _forbidden(m)] == []
    assert "yaml" not in mods  # importing the port needs no PyYAML


def _cuda_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_a_card(monkeypatch):
    from repro_torch.core import ClusterState, Registry, SchedulerSession
    from repro_torch.kernels.affinity import affinity_valid_np, bulk_decide_np
    from repro_torch.platform import Platform

    _cuda_absent(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Platform()
    st, reg = ClusterState(), Registry()
    st.add_worker("w0", max_memory=4.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SchedulerSession(st, reg)
    args = (np.zeros((3, 2), np.int32), np.zeros((1, 2), np.int8),
            np.ones((1, 3), bool), np.zeros(3, np.float32),
            np.ones(3, np.float32), np.zeros(3, np.int32),
            np.ones(1, np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        affinity_valid_np(*args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bulk_decide_np(*args)
    # explicit choices keep working: the plain versions, the float64 twin
    assert affinity_valid_np(*args, device="cpu").tolist() == \
        [[True, True, True]] == affinity_valid_np(*args, backend="np").tolist()
    assert Platform(backend="np").session.backend == "np"


def test_wrappers_take_no_other_route(monkeypatch):
    """A tensor on a device other than the CPU or a CUDA card reaches
    neither the plain version nor the kernel, and the kernel wrappers refuse
    host tensors: the only way to the plain version is a CPU tensor.  (That
    CUDA tensors reach the kernels shows on the card: ``chip_smoke.py``
    fails unless the main path moved both launch counters.)"""
    from repro_torch.kernels.affinity import bulk_kernel, kernel, ops

    calls = []
    monkeypatch.setattr(ops, "affinity_valid_ref", lambda *a: calls.append(1))
    monkeypatch.setattr(ops, "affinity_valid_kernel",
                        lambda *a: calls.append(2))
    occ = torch.zeros((3, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.affinity_valid(occ, np.zeros((1, 2), np.int8),
                           np.ones((1, 3), bool), np.zeros(3), np.ones(3),
                           np.zeros(3), np.ones(1))
    assert calls == []
    cpu = [torch.zeros(s, dtype=d) for s, d in (
        ((3, 2), torch.int32), ((1, 2), torch.int8), ((1, 3), torch.bool),
        ((3,), torch.float32), ((3,), torch.float32), ((3,), torch.int32),
        ((1,), torch.float32), ((1,), torch.float32), ((1,), torch.int32))]
    before = (kernel.KERNEL.launches, bulk_kernel.KERNEL.launches)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        kernel.affinity_valid_kernel(*cpu)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        bulk_kernel.bulk_decide_kernel(
            *cpu, torch.zeros(1, dtype=torch.int32),
            torch.zeros((1, 3), dtype=torch.int32))
    assert (kernel.KERNEL.launches, bulk_kernel.KERNEL.launches) == before


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    """No card: a non-zero exit and no result line.  Copied into a directory
    with nothing else of the repo: the same."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              capture_output=True, text=True, env=env,
                              timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
