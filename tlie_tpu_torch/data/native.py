"""The native data generators: the repository's ``csrc/mqar_gen.cpp`` (MQAR)
and ``csrc/listops_gen.cpp`` (ListOps), each built with the system ``c++``
and bound with ctypes, as ``tlie_tpu`` builds and binds them
(``tlie_tpu/native/__init__.py``).

The flags are the reference's, in its order: ``-O3 -march=native
-std=c++17 -shared -fPIC``, with ``-fopenmp`` first and without it where
that fails.  The source draws each example from its own seeded generator,
so the arrays do not depend on the thread count.  The library goes into
``tlie_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash of
the source and the flags that built it, written to a temporary name and
renamed into place.  Where no compiler builds it, :func:`mqar_generate_native`
and :func:`listops_generate_native` return None and the caller draws with
numpy or Python, as the reference does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

CSRC = Path(__file__).resolve().parents[2] / "csrc"
SOURCE = CSRC / "mqar_gen.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

_I32P, _I64P = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
# each generator: (source, C entry, its argument types)
GENERATORS = {
    "mqar_gen": (SOURCE, "mqar_generate", [
        _I64P, _I64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_uint64, ctypes.c_int,
    ]),
    "listops_gen": (CSRC / "listops_gen.cpp", "listops_generate", [
        _I32P, _I32P, _I64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64, ctypes.c_int,
    ]),
}

_libs: Dict[str, Optional[ctypes.CDLL]] = {}


def _compile(name: str = "mqar_gen") -> Optional[Path]:
    """The built library of generator ``name``, or None where neither flag
    set compiles it."""
    source = GENERATORS[name][0]
    src = source.read_bytes()
    for extra in (("-fopenmp",), ()):
        flags = CXX_FLAGS + extra
        digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
        out = BUILD_DIR / f"{name}-{digest}.so"
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run(["c++", *flags, str(source), "-o", str(tmp)], check=True,
                           capture_output=True, timeout=300)
        except (subprocess.CalledProcessError, subprocess.TimeoutExpired, FileNotFoundError):
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        return out
    return None


def _load(name: str = "mqar_gen") -> Optional[ctypes.CDLL]:
    """Generator ``name``'s library, built on first use; None (remembered)
    where no compiler builds it."""
    if name not in _libs:
        so = _compile(name)
        lib = None
        if so is not None:
            _, entry, argtypes = GENERATORS[name]
            lib = ctypes.CDLL(str(so))
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = None
        _libs[name] = lib
    return _libs[name]


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


#: canonical ListOps token ids emitted by csrc/listops_gen.cpp
LISTOPS_TOKENS = tuple(str(d) for d in range(10)) + ("[MIN", "[MAX", "[MED", "[SM", "X")


def listops_generate_native(n: int, seed: int, min_length: int = 500, max_length: int = 2000,
                            l_max: int = 2048, max_depth: int = 10, max_args: int = 10,
                            threads: int = 0
                            ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(tokens (n, l_max) int32 canonical ids padded with -1, lengths (n,)
    int32, targets (n,) int64) from the C++ growth-scheme generator, or
    None when no compiler builds it.  Canonical id i is
    ``LISTOPS_TOKENS[i]``.  Each example draws from its own seeded
    generator, so the arrays do not depend on ``threads``."""
    lib = _load("listops_gen")
    if lib is None:
        return None
    tokens = np.empty((n, l_max), dtype=np.int32)
    lengths = np.empty((n,), dtype=np.int32)
    targets = np.empty((n,), dtype=np.int64)
    lib.listops_generate(
        tokens.ctypes.data_as(_I32P), lengths.ctypes.data_as(_I32P),
        targets.ctypes.data_as(_I64P),
        n, l_max, min_length, max_length, max_depth, max_args, seed, threads,
    )
    return tokens, lengths, targets
