"""Build the package's CUDA sources with plain ``nvcc`` and bind them with ctypes.

Each ``ops/csrc/*.cu`` file has a plain C interface and includes no PyTorch
header, so ``nvcc`` turns it into a shared library in seconds.  The library
is built at first use into ``tlie_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of its source and flags, so an edited source
is rebuilt and a stale library is never loaded; the hash also covers the
headers of ``csrc/`` (``*.cuh``), which the sources include.  The build writes to a
temporary name and renames it into place: no lock file, no half-written
library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# Launches of each kernel, by name: each wrapper adds one where it launches
# its kernel and nowhere else, so a run can show that it went through it.
LAUNCHES: Dict[str, int] = {}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under PyTorch's CUDA_HOME; raises if neither."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.is_file():
            return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME: the CUDA kernels of "
        "tlie_tpu_torch are built from source at first use"
    )


class BuildReport:
    """What one build did: the library path, its seconds (0 when it was
    already built) and the compiler's resource report (``-Xptxas -v``)."""

    def __init__(self, path: Path, seconds: float, log: str):
        self.path, self.seconds, self.log = path, seconds, log


def build(name: str) -> BuildReport:
    """Compile ``csrc/<name>.cu`` into ``_build/<name>-<hash>.so`` unless that
    library exists already."""
    src = CSRC / f"{name}.cu"
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return BuildReport(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {src}:\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return BuildReport(out, seconds, proc.stdout + proc.stderr)


class CudaLibrary:
    """A lazily built and loaded kernel library.

    ``signatures`` maps each exported C function to its ctypes argtypes;
    every function returns a CUDA error code as ``int``.  Nothing is built or
    loaded until :meth:`fn` is first called, so importing a module that holds
    a ``CudaLibrary`` needs no compiler and no card."""

    def __init__(self, name: str, signatures: Dict[str, tuple]):
        self.name = name
        self.signatures = signatures
        self._lib: Optional[ctypes.CDLL] = None
        self.report: Optional[BuildReport] = None

    def load(self) -> BuildReport:
        if self._lib is None:
            self.report = build(self.name)
            lib = ctypes.CDLL(str(self.report.path))
            for fname, argtypes in self.signatures.items():
                f = getattr(lib, fname)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            self._lib = lib
        return self.report

    def fn(self, fname: str):
        self.load()
        return getattr(self._lib, fname)


def check(err: int, what: str) -> None:
    """Raise on a non-zero CUDA error code returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: launch failed with cudaError_t {err}")
