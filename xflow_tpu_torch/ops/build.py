"""Builds the hand-written CUDA kernels under ``csrc/`` with ``nvcc``
into shared libraries with a plain C interface, bound with ``ctypes``.

A library builds at first use into ``xflow_tpu_torch/_build/`` (listed
in .gitignore), named by a hash of its source and the flags, so an
edited source rebuilds and an unchanged one loads from the cache.
Nothing here runs at import time: the CPU tests import every module on
a host without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
# sm_90a (not sm_90): Hopper's wgmma/setmaxnreg exist only there, and
# later kernels will want them.  -Xptxas -v writes each kernel's
# registers, shared memory and spills into the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 600.0

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin or /usr/local/cuda/bin) "
            "— the CUDA kernels build only on a host with the CUDA toolkit"
        )
    return path


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by the hash of the
    source and the flags."""
    h = hashlib.sha256()
    h.update((CSRC_DIR / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> float:
    """Build ``csrc/<name>.cu`` unless it is cached; returns the seconds
    ``nvcc`` took (0.0 when cached).  Raises RuntimeError with the
    compiler output on a failed build.  The output is written under a
    temporary name and renamed into place, so a concurrent loader never
    sees half a library."""
    out = library_path(name)
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{name}-", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            timeout=BUILD_TIMEOUT_S,
        )
    except subprocess.TimeoutExpired:
        os.unlink(tmp)
        raise RuntimeError(
            f"csrc/{name}.cu: nvcc timed out after {BUILD_TIMEOUT_S}s"
        ) from None
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"kernel build failed: csrc/{name}.cu\n{proc.stdout}")
    out.with_suffix(".log").write_text(proc.stdout)
    os.replace(tmp, out)
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """The compiler's output for the cached build of ``name`` (ptxas
    register / spill report)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed; loaded once per process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
