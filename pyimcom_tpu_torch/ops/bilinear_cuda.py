"""
The port's hand-written Hopper kernels for the destriping bilinear pair,
and their ctypes wrappers.

K3 ``bilinear_gather`` replaces the JAX package's device gathers
``bilinear_gather_device`` and ``bilinear_gather_weighted_device``
(``pyimcom_tpu/ops/bilinear.py``); K4 ``bilinear_scatter_adjoint`` replaces
``bilinear_scatter_adjoint_device`` and, with a gain, the image cotangent
that ``jax.value_and_grad`` takes through the destripe cost's weighted
gather.  Both live in ``csrc/bilinear.cu`` (its header says what bounds them
on the card and what the design does about it), built by ``nvcc`` at first
use (``_build.py``).  A wrapper takes contiguous f64 CUDA tensors on one
device only and raises on anything else; it launches on the current stream,
allocates its output with torch, checks the launch and counts it in
``launches``.  The plain versions are in ``ops/bilinear.py``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .interp_cuda import _check

# launches of each kernel since the last reset_launch_counts(); incremented
# by the wrappers where they launch, and nowhere else
launches = {"bilinear_gather": 0, "bilinear_scatter_adjoint": 0}

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "bilinear_gather": (_p, _p, _i, _i, _p, _p, _ll, _p, _i, _p),
    "bilinear_scatter_adjoint": (_p, _p, _i, _i, _p, _p, _ll, _p, _p),
}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def _launch(name: str, device: torch.device, *args) -> None:
    fn = getattr(_build.library("bilinear"), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
    launches[name] += 1


def _check_pair(shape, xf, yf, g_eff, dev):
    """Check the positions and the gain; returns (ny, nx)."""
    _check(xf, "xf", torch.float64, dev, xf.dim())
    _check(yf, "yf", torch.float64, dev, yf.dim())
    if yf.shape != xf.shape:
        raise ValueError(f"xf and yf must have one shape, got {tuple(xf.shape)} and "
                         f"{tuple(yf.shape)}")
    if g_eff is not None:
        _check(g_eff, "g_eff", torch.float64, dev, 2)
        if tuple(g_eff.shape) != tuple(shape):
            raise ValueError(f"g_eff must have the image's shape {tuple(shape)}, got "
                             f"{tuple(g_eff.shape)}")
    ny, nx = shape
    if ny * nx >= 2 ** 31:
        raise ValueError("K3 and K4 index the image with int32: it must hold fewer than "
                         "2**31 pixels")
    return ny, nx


def _ptr(t):
    return None if t is None else t.data_ptr()


def bilinear_gather(image: torch.Tensor, xf: torch.Tensor, yf: torch.Tensor,
                    g_eff: torch.Tensor | None = None, *,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """
    K3: image (ny, nx), xf, yf (any shape, one shape) f64 CUDA -> the
    bilinear values at (xf, yf), 0 out of bounds or at a NaN position; with
    `g_eff` (ny, nx), gain-weighted and normalised.  With `out` (xf's shape)
    the values are added into it in place, and it is returned.
    """
    dev = image.device
    _check(image, "image", torch.float64, dev, 2)
    ny, nx = _check_pair(image.shape, xf, yf, g_eff, dev)
    if out is None:
        result = torch.empty(xf.shape, dtype=torch.float64, device=dev)
    else:
        _check(out, "out", torch.float64, dev, out.dim())
        if out.shape != xf.shape:
            raise ValueError(f"out must have xf's shape {tuple(xf.shape)}, got "
                             f"{tuple(out.shape)}")
        result = out
    if xf.numel() == 0:
        return result
    _launch("bilinear_gather", dev, image.data_ptr(), _ptr(g_eff), ny, nx, xf.data_ptr(),
            yf.data_ptr(), xf.numel(), result.data_ptr(), int(out is not None))
    return result


def bilinear_scatter_adjoint(values: torch.Tensor, xf: torch.Tensor, yf: torch.Tensor,
                             shape, g_eff: torch.Tensor | None = None) -> torch.Tensor:
    """
    K4: the exact adjoint of K3 with respect to the image: values, xf, yf
    (one shape) f64 CUDA -> (ny, nx) = `shape`, each in-bounds value added
    into its four taps with K3's weights (and gain).  The sums are taken
    with atomics, in no fixed order.
    """
    dev = values.device
    _check(values, "values", torch.float64, dev, values.dim())
    ny, nx = _check_pair(tuple(shape), xf, yf, g_eff, dev)
    if values.shape != xf.shape:
        raise ValueError(f"values must have xf's shape {tuple(xf.shape)}, got "
                         f"{tuple(values.shape)}")
    out = torch.zeros((ny, nx), dtype=torch.float64, device=dev)
    if xf.numel() == 0:
        return out
    _launch("bilinear_scatter_adjoint", dev, values.data_ptr(), _ptr(g_eff), ny, nx,
            xf.data_ptr(), yf.data_ptr(), xf.numel(), out.data_ptr())
    return out
