"""Fault-tolerant checkpointing, the reference's ``checkpoint/manager.py``
for trees of tensors (nested dicts and lists, as a model's
``named_parameters()`` and the optimizer state make them).

* **one file per leaf**: every leaf is written as its own ``.npy`` under
  the step directory;
* **atomic**: writes land in ``step_K.tmp-<nonce>``, the manifest is
  written last, then the directory is renamed: a crash mid-save never
  corrupts the latest checkpoint;
* **async**: ``save(..., blocking=False)`` copies the leaves to the host
  first, then hands the writing to a thread, so the train loop overlaps
  I/O with the next step; the thread's error surfaces at ``wait()``;
* **restore** into the structure of a template tree, each leaf checked
  against the template's shape and placed on the template leaf's device
  in its dtype.

numpy has no bfloat16, so a bfloat16 leaf is stored as its raw bytes
(``uint8``) with ``"bfloat16"`` in the manifest and read back through a
``torch`` view; nothing here needs ``ml_dtypes``.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from pathlib import Path
from typing import Any, List, Mapping, Optional, Tuple

import numpy as np
import torch

#: dtypes stored as raw bytes (numpy has no such type)
_RAW = {"bfloat16": torch.bfloat16}


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in order, keys joined by "/" as the reference's."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += _flatten(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def _unflatten(template, leaves: dict, prefix: str = ""):
    """``template``'s structure with each leaf taken from ``leaves``."""
    def key(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(template, Mapping):
        return {k: _unflatten(v, leaves, key(k)) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves, key(i))
                              for i, v in enumerate(template))
    return leaves[prefix]


def _to_host(leaf) -> Tuple[np.ndarray, str, List[int]]:
    """A leaf as the numpy array to write, and the dtype and shape the
    manifest records (a raw leaf's bytes are written flat).  The array is a
    copy, whatever device the leaf lies on: the train step updates
    parameters and optimizer state in place while an async save writes
    them (on a card, the one device -> host copy is this copy)."""
    t = torch.as_tensor(leaf).detach().to(
        "cpu", copy=True, memory_format=torch.contiguous_format)
    name = str(t.dtype).removeprefix("torch.")
    if name in _RAW:
        return t.reshape(-1).view(torch.uint8).numpy(), name, list(t.shape)
    return t.numpy(), name, list(t.shape)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ---- save ---------------------------------------------------------------- #

    def save(self, step: int, tree, *, blocking: bool = True) -> None:
        self.wait()  # one async save in flight at a time
        # device -> host now
        host = [(k, *_to_host(v)) for k, v in _flatten(tree)]

        def write():
            try:
                tmp = Path(tempfile.mkdtemp(prefix=f"step_{step}.tmp-",
                                            dir=self.dir))
                manifest = {"step": step, "leaves": []}
                for k, arr, dtype, shape in host:
                    fn = k.replace("/", "__") + ".npy"
                    np.save(tmp / fn, arr)
                    manifest["leaves"].append(
                        {"key": k, "file": fn, "shape": shape,
                         "dtype": dtype})
                (tmp / "manifest.json").write_text(json.dumps(manifest))
                final = self.dir / f"step_{step}"
                if final.exists():
                    shutil.rmtree(final)
                os.rename(tmp, final)  # atomic commit
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        if blocking:
            write()
            self.wait()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ---- restore ------------------------------------------------------------- #

    def steps(self) -> List[int]:
        out = []
        for p in self.dir.iterdir():
            if p.is_dir() and p.name.startswith("step_") and \
                    ".tmp-" not in p.name:
                if (p / "manifest.json").exists():
                    out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None):
        """Restore into the structure of ``template`` (a tree of tensors):
        each leaf as a tensor of the template leaf's dtype on its device.
        Raises ``KeyError`` for a leaf the checkpoint lacks and
        ``ValueError`` for a shape that differs from the template's."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        by_key = {e["key"]: e for e in manifest["leaves"]}
        leaves = {}
        for k, tmpl in _flatten(template):
            e = by_key.get(k)
            if e is None:
                raise KeyError(f"checkpoint {step} missing leaf {k!r}")
            t = torch.from_numpy(np.load(d / e["file"]))
            if e["dtype"] in _RAW:
                t = t.view(_RAW[e["dtype"]]).reshape(e["shape"])
            tmpl = torch.as_tensor(tmpl)
            if tuple(t.shape) != tuple(tmpl.shape):
                raise ValueError(f"leaf {k!r}: shape {tuple(t.shape)} != "
                                 f"{tuple(tmpl.shape)}")
            leaves[k] = t.to(device=tmpl.device, dtype=tmpl.dtype)
        return _unflatten(template, leaves)
