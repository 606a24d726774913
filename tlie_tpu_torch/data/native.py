"""The native MQAR generator: the repository's ``csrc/mqar_gen.cpp``, built
with the system ``c++`` and bound with ctypes, as ``tlie_tpu`` builds and
binds it (``tlie_tpu/native/__init__.py``).

The flags are the reference's, in its order: ``-O3 -march=native
-std=c++17 -shared -fPIC``, with ``-fopenmp`` first and without it where
that fails.  The source draws each example from its own seeded generator,
so the arrays do not depend on the thread count.  The library goes into
``tlie_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash of
the source and the flags that built it, written to a temporary name and
renamed into place.  Where no compiler builds it, :func:`mqar_generate_native`
returns None and the caller draws with numpy, as the reference does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "mqar_gen.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _compile() -> Optional[Path]:
    """The built library, or None where neither flag set compiles."""
    src = SOURCE.read_bytes()
    for extra in (("-fopenmp",), ()):
        flags = CXX_FLAGS + extra
        digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
        out = BUILD_DIR / f"mqar_gen-{digest}.so"
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run(["c++", *flags, str(SOURCE), "-o", str(tmp)], check=True,
                           capture_output=True, timeout=300)
        except (subprocess.CalledProcessError, subprocess.TimeoutExpired, FileNotFoundError):
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        return out
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is None and not _build_failed:
        so = _compile()
        if so is None:
            _build_failed = True
            return None
        lib = ctypes.CDLL(str(so))
        lib.mqar_generate.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_double, ctypes.c_uint64, ctypes.c_int,
        ]
        lib.mqar_generate.restype = None
        _lib = lib
    return _lib


def mqar_generate_native(vocab_size: int, num_examples: int, input_seq_len: int, seed: int,
                         power_a: float = 0.01, num_kv_pairs: int = 8,
                         random_non_queries: bool = True
                         ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(inputs, labels) int64 (num_examples, input_seq_len) from the C++
    generator, or None when no compiler builds it."""
    lib = _load()
    if lib is None:
        return None
    inputs = np.empty((num_examples, input_seq_len), dtype=np.int64)
    labels = np.empty((num_examples, input_seq_len), dtype=np.int64)
    lib.mqar_generate(
        inputs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        num_examples, input_seq_len, vocab_size, num_kv_pairs,
        power_a, seed, int(random_non_queries),
    )
    return inputs, labels
