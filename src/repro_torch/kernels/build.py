"""Build and bind the port's hand-written CUDA kernels.

Each kernel is one ``.cu`` source under ``kernels/<family>/csrc/`` with a
plain ``extern "C"`` entry point: ``nvcc`` compiles it for Hopper
(``sm_90a``) into a shared library under ``build/repro_torch/`` at the root
of the checkout, on first use, and :mod:`ctypes` loads it.  No PyTorch
headers are compiled, so a build takes seconds, not minutes.  The library
name carries a digest of the sources and flags, so an edited source is
rebuilt and a stale library is never loaded.

Nothing here runs at import time: the CPU tests import every module of the
port on machines with no ``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Iterable, Optional, Sequence, Tuple

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch"
#: ``-Xptxas -v``: each build's registers and spills, kept in ``build_log``
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: the affinity kernels repeat the reference's float32 operations one by one
#: (bit-exact against their plain versions), so nothing is contracted to FMA
EXACT_FLAGS = NVCC_FLAGS + ("--fmad=false",)


def nvcc_path() -> str:
    """The CUDA toolkit's ``nvcc`` as PyTorch locates the toolkit
    (``CUDA_HOME``/``CUDA_PATH``, ``nvcc`` on ``PATH``, or the default
    install prefix)."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: the port's kernels are "
                           "compiled with nvcc on the machine with the card")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


class CudaKernel:
    """One hand-written kernel: its source, its ctypes entry point, the
    count of launches its wrapper made (``launches``, a plain integer the
    wrapper bumps once per launch and nowhere else), and the compiler's
    output of the last build in this process (``build_log``)."""

    def __init__(self, name: str, source: str, entry: str,
                 argtypes: Sequence, headers: Iterable[str] = (),
                 flags: Sequence[str] = EXACT_FLAGS):
        self.name = name
        self.flags = tuple(flags)
        self.source = KERNELS_DIR / source
        self.headers = tuple(KERNELS_DIR / h for h in headers)
        self.entry = entry
        self.argtypes = list(argtypes)
        self.launches = 0
        self.build_log = ""
        self._lib = None
        self._fn = None

    def library_path(self) -> Path:
        h = hashlib.sha256(" ".join(self.flags).encode())
        for p in (self.source, *self.headers):
            h.update(p.read_bytes())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    def start_build(self) -> Optional[Tuple[subprocess.Popen, Path, Path]]:
        """Start ``nvcc`` for this kernel unless its library is built;
        returns ``(process, temporary output, library)``, or ``None`` when
        there is nothing to do.  The library is written under a temporary
        name and renamed, so a concurrent loader never sees a half-written
        file."""
        lib = self.library_path()
        if lib.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *self.flags, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, lib

    def fn(self):
        """The bound entry point, building the library first if needed."""
        if self._fn is None:
            self._fn = self.symbol(self.entry, self.argtypes)
        return self._fn

    def symbol(self, name: str, argtypes: Sequence):
        """The library's C function ``name`` with ``argtypes`` and an int
        result, building and loading the library first if needed."""
        if self._lib is None:
            build_all([self])
            self._lib = ctypes.CDLL(str(self.library_path()))
        fn = getattr(self._lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        return fn


def build_all(kernels: Sequence[CudaKernel]) -> float:
    """Build every kernel whose library is missing, one ``nvcc`` per source,
    all started together.  Returns the wall seconds of the whole build (about
    0 when every library was already there) and raises with the compiler's
    output if any build fails."""
    t0 = time.perf_counter()
    started = [(k, k.start_build()) for k in kernels]
    failures = []
    for k, job in started:
        if job is None:
            continue
        proc, tmp, lib = job
        out, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{k.name} ({k.source}):\n{out}")
        else:
            os.replace(tmp, lib)
            k.build_log = out
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return time.perf_counter() - t0
