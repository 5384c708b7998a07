"""
Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``_build/lib<name>_<hash>.so`` inside the
package (a directory that ``.gitignore`` lists), then loaded with ctypes.
The file name carries a hash of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded.  Nothing here runs
at import time: the CPU tests import every module without a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: on PATH, else the toolkit's default home."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of pyimcom_tpu_torch "
                       "need the CUDA toolkit to build")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` now; returns the compiler's report
    (ptxas register and spill counts).  Raises on a failed build."""
    out = library_path(name)
    BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return proc.stdout + proc.stderr


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build(name)
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib
