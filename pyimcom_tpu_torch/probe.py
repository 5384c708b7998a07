"""
Build-and-launch probe of the port's CUDA toolchain on the card.

    python -m pyimcom_tpu_torch.probe      # needs a CUDA GPU and nvcc

Counterpart of scripts/probe_pallas.py, the JAX package's Mosaic compile
probe.  It builds ``csrc/probe.cu`` with ``nvcc`` for ``sm_90a``, launches
the probe kernel on an (8, 128) float32 zero tensor on ``cuda:0``, checks
that every element is exactly 1.0 and prints one JSON verdict line
``{"probe": "cuda_sm90a_build_launch", "ok": ..., "build_s": ..., "nvcc":
...}``.  A machine without a GPU, a failed build and a failed launch raise
and exit non-zero.

:func:`probe_add_one` is the kernel's wrapper: a CUDA tensor launches the
kernel (and counts the launch in ``launches``), a CPU tensor takes the
plain version ``x + 1.0``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time

import torch

from . import _build

# launches of the probe kernel since the last reset_launch_counts()
launches = {"probe_add_one": 0}


def reset_launch_counts() -> None:
    launches["probe_add_one"] = 0


def probe_add_one_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the probe kernel (same function, any device)."""
    return x + 1.0


def probe_add_one(x: torch.Tensor) -> torch.Tensor:
    """x + 1.0 for a float32 tensor: the probe kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return probe_add_one_plain(x)
    if not x.is_cuda:
        raise ValueError(f"probe_add_one: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be torch.float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    fn = _build.library("probe").probe_add_one
    fn.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)
    fn.restype = ctypes.c_int
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), x.numel(),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel probe_add_one failed to launch: cudaError {err}")
    launches["probe_add_one"] += 1
    return out


def run() -> dict:
    """Build the probe library, launch the kernel once on cuda:0 and check
    its result; returns the verdict (raises on any failure)."""
    if not torch.cuda.is_available():
        raise RuntimeError("probe: no CUDA GPU is available")
    version = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                             text=True, check=True).stdout.strip().splitlines()[-1]
    t0 = time.perf_counter()
    _build.build("probe")
    build_s = time.perf_counter() - t0
    x = torch.zeros((8, 128), dtype=torch.float32, device="cuda:0")
    y = probe_add_one(x)
    torch.cuda.synchronize()
    ok = bool(torch.equal(y, probe_add_one_plain(x)))
    return {"probe": "cuda_sm90a_build_launch", "ok": ok, "build_s": build_s,
            "nvcc": version}


def main() -> int:
    verdict = run()
    print(json.dumps(verdict), flush=True)
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
