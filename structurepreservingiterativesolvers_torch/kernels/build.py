"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/*.cu`` file exposes a plain C interface and is compiled by
``nvcc`` into ``build/torch_kernels/`` at the root of the checkout, keyed by a
hash of the source, the headers it includes from ``csrc/`` and the flags,
then loaded with ``ctypes``.  Nothing is built when a module is imported:
the first launch on a CUDA tensor builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _with_headers(src: Path) -> list:
    """``src`` and, recursively, the headers of ``csrc/`` that it includes
    with quotes, each once, in the order first met."""
    seen, todo = [], [src]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for name in _INCLUDE.findall(path.read_text()):
            header = path.parent / name
            if header.is_file():
                todo.append(header)
    return seen


def source_key(src: Path) -> str:
    """The build key of ``src``: a hash of it, of the headers it includes and
    of the flags, so that an edited header rebuilds every source that
    includes it."""
    return hashlib.sha256(
        b"".join(p.read_bytes() for p in _with_headers(src))
        + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install location."""
    candidates = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        candidates.append(os.path.join(home, "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


@functools.lru_cache(maxsize=None)
def build(source_name: str) -> tuple:
    """Compile ``csrc/<source_name>`` if its library is not built yet;
    returns ``(library path, compiler log)``.  The log is empty when the
    library was already there."""
    src = CSRC_DIR / source_name
    key = source_key(src)
    out = BUILD_DIR / f"{src.stem}_{key}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a per-process name, then rename: a concurrent build never
    # loads a half-written library
    tmp = BUILD_DIR / f"{src.stem}_{key}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {src} (exit {proc.returncode}):\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load(source_name: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<source_name>``."""
    path, _ = build(source_name)
    return ctypes.CDLL(str(path))
