"""Builds the port's copy of the native libffm parser (``src/parser.cc``,
byte-equal to the reference's) with the system ``g++`` at first use.

The library goes into ``xflow_tpu_torch/_build/`` (listed in
.gitignore), never beside the sources, named by a hash of the source
and the flags: an edited source rebuilds, an unchanged one loads from
the cache.  The compiler writes under a temporary name that is renamed
into place, so parallel test workers that build at once race benignly
and no loader ever sees half a library.  Nothing here runs at import
time.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src" / "parser.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# the reference's native/build.py flags
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall")
BUILD_TIMEOUT_S = 300.0


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXXFLAGS).encode())
    return BUILD_DIR / f"libxflow_io-{h.hexdigest()[:16]}.so"


def build_if_needed() -> Path:
    """The built library's path, compiling it first unless cached.
    Raises RuntimeError (no ``g++``, or a failed or timed-out build)."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native parser cannot build here")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".xflow_io-", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [cxx, *CXXFLAGS, "-o", tmp, str(SRC)],
            capture_output=True, text=True, timeout=BUILD_TIMEOUT_S,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"native parser build failed:\n{proc.stderr}")
        os.replace(tmp, out)
    except subprocess.TimeoutExpired:
        raise RuntimeError(
            f"native parser build timed out after {BUILD_TIMEOUT_S}s"
        ) from None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out
