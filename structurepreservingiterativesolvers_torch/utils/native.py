"""ctypes bindings for the repository's C++ host kernels (``native/``).

The port of the JAX package's ``utils/native.py``: a CSR SpMV and an ILU(0)
factor with its triangular solves, host code from ``native/spkernels.cpp``.
The source is compiled at first use with ``g++ -O3 -shared -fPIC`` into
``build/native/`` at the root of the checkout (gitignored), keyed by a hash
of the source and the flags, and loaded with ``ctypes``; nothing is ever
written into ``native/``.  Callers check ``available()`` and use the scipy
equivalents where no compiler is there.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "spkernels.cpp"
BUILD_DIR = ROOT / "build" / "native"
# no -march=native: the library lands in a build directory that a copy of
# the working tree may carry to another machine
CXX_FLAGS = ("-O3", "-shared", "-fPIC")


def library_path() -> Path:
    """Where the library of the current source and flags is built."""
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libspkernels_{key}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a per-process name, then rename: a concurrent build never
    # loads a half-written library
    tmp = BUILD_DIR / f"{out.stem}.{os.getpid()}.tmp"
    subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                   check=True, capture_output=True)
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(str(_build()))
    except (OSError, subprocess.CalledProcessError):  # no toolchain
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.csr_spmv_f64.argtypes = [ctypes.c_int64, i64p, i64p, f64p, f64p, f64p]
    lib.ilu0_factor_f64.restype = ctypes.c_int64
    lib.ilu0_factor_f64.argtypes = [ctypes.c_int64, i64p, i64p, f64p, i64p]
    lib.ilu0_solve_f64.argtypes = [ctypes.c_int64, i64p, i64p, f64p, i64p,
                                   f64p, f64p]
    return lib


def available() -> bool:
    return _load() is not None


def _as_i64(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def _ptr(a, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def csr_spmv(A_csr, x: np.ndarray) -> np.ndarray:
    """y = A x for a scipy CSR matrix A, in f64."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native kernels unavailable")
    n = A_csr.shape[0]
    indptr = _as_i64(A_csr.indptr)
    indices = _as_i64(A_csr.indices)
    data = np.ascontiguousarray(A_csr.data, dtype=np.float64)
    x = np.ascontiguousarray(x, dtype=np.float64)
    y = np.empty(n, dtype=np.float64)
    lib.csr_spmv_f64(n, _ptr(indptr, ctypes.c_int64),
                     _ptr(indices, ctypes.c_int64),
                     _ptr(data, ctypes.c_double), _ptr(x, ctypes.c_double),
                     _ptr(y, ctypes.c_double))
    return y


class ILU0:
    """Native ILU(0) factor with a scipy-spilu-like ``.solve`` interface
    (the reference's preconditioner protocol, solvers.py:64-66)."""

    def __init__(self, A_csr):
        import scipy.sparse as sp

        lib = _load()
        if lib is None:
            raise RuntimeError("native kernels unavailable")
        A = sp.csr_matrix(A_csr).sorted_indices()
        n = A.shape[0]
        self.n = n
        self.indptr = _as_i64(A.indptr)
        self.indices = _as_i64(A.indices)
        self.data = np.ascontiguousarray(A.data, dtype=np.float64).copy()
        self.diag_pos = np.empty(n, dtype=np.int64)
        rc = lib.ilu0_factor_f64(
            n, _ptr(self.indptr, ctypes.c_int64),
            _ptr(self.indices, ctypes.c_int64),
            _ptr(self.data, ctypes.c_double),
            _ptr(self.diag_pos, ctypes.c_int64),
        )
        if rc != 0:
            raise ZeroDivisionError(f"zero pivot at row {rc - 1}")
        self._lib = lib

    def solve(self, b: np.ndarray) -> np.ndarray:
        b = np.ascontiguousarray(b, dtype=np.float64)
        x = np.empty(self.n, dtype=np.float64)
        self._lib.ilu0_solve_f64(
            self.n, _ptr(self.indptr, ctypes.c_int64),
            _ptr(self.indices, ctypes.c_int64),
            _ptr(self.data, ctypes.c_double),
            _ptr(self.diag_pos, ctypes.c_int64), _ptr(b, ctypes.c_double),
            _ptr(x, ctypes.c_double),
        )
        return x
