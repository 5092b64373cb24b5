"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on first use into
``scenario_wise_rec_tpu_torch/_build/lib<name>-<hash>.so`` with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v

and loaded with ``ctypes``. The hash covers the source, the headers beside
it and the flags, so an edited source is rebuilt. The sources have a plain
C interface and include no PyTorch header, which keeps a build to seconds.
No network, no ``ninja``: only the CUDA toolkit's ``nvcc``.

This module imports nothing CUDA-specific; nothing is built until a kernel
is launched on a CUDA tensor (or :func:`build` is called). Processes that
share the build directory (the ranks of a mesh) take turns through a file
lock, so no two compile a source at once: the later one finds it built.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# compiler output (ptxas registers/spills) of builds made in this process
build_logs: Dict[str, str] = {}


def sources() -> list:
    """Names of every kernel source, ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
        "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the CUDA kernels are compiled from "
        f"{CSRC_DIR} with the CUDA toolkit")


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC_DIR / f"{name}.cu"] + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


@contextlib.contextmanager
def _process_lock():
    """The build directory's lock, held against other processes."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (default: all) that are not built yet,
    one nvcc per source, all started together. Returns the seconds each
    build took (0.0 when it was already built). Raises on a failed build."""
    names = list(sources() if names is None else names)
    with _lock, _process_lock():
        jobs = {}
        seconds = {}
        for name in names:
            lib = _library_path(name)
            if lib.exists():
                seconds[name] = 0.0
                continue
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC_DIR / f"{name}.cu")]
            jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True),
                          tmp, lib, time.perf_counter())
        failed = []
        for name, (proc, tmp, lib, t0) in jobs.items():
            log, _ = proc.communicate()
            seconds[name] = time.perf_counter() - t0
            build_logs[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
                tmp.unlink(missing_ok=True)
                continue
            os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(_library_path(name)))
        return _loaded[name]
