"""Build-on-first-use for the port's hand-written CUDA kernels.

Each kernel source under `internnav_tpu_torch/csrc/` exposes a plain C entry
point. It is compiled with `nvcc` into a shared library under
`build/kernels/` at the repository root (git-ignored) and loaded with
ctypes. The library name carries a hash of the source and the flags, so an
edited source rebuilds and an unchanged one loads from disk; the compiler's
output (ptxas registers, spills) is kept beside it as `<library>.log`.

Importing this module needs no compiler: `nvcc` is looked up only when a
build is requested, and a missing compiler raises there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

_lock = threading.Lock()
_source_locks: Dict[str, threading.Lock] = {}
_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else `nvcc` on PATH, else the
    toolkit's default install prefix."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "of internnav_tpu_torch are built on first use")


def library_path(source: str) -> Path:
    """Where `csrc/<source>` builds to: named by a hash of source + flags."""
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}_{digest}.so"


def load_library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<source>` as a shared library.
    Calls for different sources from different threads compile
    concurrently; calls for one source wait for its single build."""
    with _lock:
        source_lock = _source_locks.setdefault(source, threading.Lock())
    with source_lock:
        if source in _loaded:
            return _loaded[source]
        src = CSRC / source
        lib_path = library_path(source)
        if not lib_path.exists():
            _compile(src, lib_path)
        lib = ctypes.CDLL(str(lib_path))
        _loaded[source] = lib
        return lib


def _compile(src: Path, lib_path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    output = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {src.name}:\n{output}")
    lib_path.with_suffix(".log").write_text(output)
    os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing
