"""
The port's hand-written Hopper kernels for D5512 interpolation, their
ctypes wrappers, and their plain PyTorch versions.

K1 ``interp_d5512_dense`` replaces the JAX package's TPU interpolation
kernel (R images at R x Nq scattered points; its dense contract is
``pyimcom_tpu.ops.interp.interp2d_dense``).  It serves the PSF resampling
and the star injection.

K2 ``sweep_d5512_scatter`` replaces that kernel's outer-difference-query
variant, fused with the scatters of ``pyimcom_tpu/ops/assemble.py``'s
``sweep_pool_scan`` (mode 0, the submatrix pool) and ``sweep_b_scan``
(mode 1, -B/2): each query is formed from the f64 coordinate tables,
interpolated and added where it lands.

Both live in ``csrc/interp_d5512.cu`` (its header names the TPU kernel
file and functions they replace, what bounds them on the card and what the
design does about it), built by ``nvcc`` at first use (``_build.py``).  A
wrapper takes CUDA tensors only and raises on anything else; it launches on
the current stream, allocates its outputs with torch, checks the launch,
and counts it in ``launches``.  The plain versions compute the same
function with a gather of the 10x10 patches, two contractions and
``index_add_``; the CPU path uses them, and ``chip_smoke.py``
holds each kernel against its plain version on the card.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import interp as _interp

# launches of each kernel since the last reset_launch_counts(); incremented
# by the wrappers where they launch, and nowhere else
launches = {"interp_d5512_dense": 0, "sweep_d5512_scatter": 0}

_p, _i, _ll, _d = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
_SIGNATURES = {
    "interp_d5512_dense": (_p, _i, _i, _i, _p, _p, _ll, _p, _p),
    "sweep_d5512_scatter": (_p, _ll, _p, _i, _i, _i, _p, _p, _ll, _p, _p, _p,
                            _ll, _i, _d, _d, _i, _i, _i, _p),
}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def _cfunc(name: str):
    fn = getattr(_build.library("interp_d5512"), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, dtype, device, ndim: int) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _cfunc(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
    launches[name] += 1


# --------------------------------------------------------------------------
# K1: dense scattered-point interpolation
# --------------------------------------------------------------------------

def interp_d5512_dense(images: torch.Tensor, x: torch.Tensor,
                       y: torch.Tensor) -> torch.Tensor:
    """K1: images (R, ny, nx), x, y (R, Nq), f64 CUDA -> (R, Nq), 0 off-grid."""
    dev = images.device
    _check(images, "images", torch.float64, dev, 3)
    R, ny, nx = images.shape
    _check(x, "x", torch.float64, dev, 2)
    _check(y, "y", torch.float64, dev, 2)
    if x.shape[0] != R or y.shape != x.shape:
        raise ValueError(f"x, y must be (R={R}, Nq); got {tuple(x.shape)}, "
                         f"{tuple(y.shape)}")
    out = torch.empty(x.shape, dtype=torch.float64, device=dev)
    _launch("interp_d5512_dense", dev, images.data_ptr(), R, ny, nx,
            x.data_ptr(), y.data_ptr(), x.shape[1], out.data_ptr())
    return out


def interp_d5512_dense_plain(images: torch.Tensor, x: torch.Tensor,
                             y: torch.Tensor) -> torch.Tensor:
    """Plain version of K1 (same function, any device)."""
    R, Nq = x.shape
    which = torch.arange(R, device=images.device).repeat_interleave(Nq)
    return _interp.interp2d_stack(images, x.reshape(-1), y.reshape(-1),
                                  which).reshape(R, Nq)


# --------------------------------------------------------------------------
# K2: fused sweep (query formation + interpolation + scatter-add)
# --------------------------------------------------------------------------

def _sweep_args(ks, imeta, dmeta, mode, n_pad, m):
    if mode not in (0, 1):
        raise ValueError(f"mode must be 0 (pool) or 1 (B), got {mode}")
    if mode == 1 and (m <= 0 or n_pad <= 0):
        raise ValueError(f"B mode needs m > 0 and n_pad > 0, got {m}, {n_pad}")
    dw = 5 if mode == 0 else 4
    ks = ks.reshape(-1)
    imeta = imeta.reshape(-1, 5)
    dmeta = dmeta.reshape(-1, dw)
    if not (ks.shape[0] == imeta.shape[0] == dmeta.shape[0]):
        raise ValueError("ks, imeta and the scatter metadata need one row each "
                         f"({ks.shape[0]}, {imeta.shape[0]}, {dmeta.shape[0]})")
    return ks, imeta, dmeta


def sweep_d5512_scatter(dst, combined, xt, yt, ks, imeta, dmeta, inv_scale,
                        off_grid, bucket: int, mode: int, n_pad: int = 0,
                        m: int = 0) -> torch.Tensor:
    """
    K2: add the interpolated overlap value of every query into `dst` (in
    place; returned).

    dst (P,) f64; combined (K, ny, nx) f64; xt, yt (L,) f64; ks (..., ) int32
    image per row; imeta (..., 5) int32 rows [i1_start, i2_start, w2, off,
    nval]; dmeta (..., 5) pool rows [dst_base0, w2, stride, off, nval] in
    mode 0, or (..., 4) B rows [dst_base, col0, off, nval] in mode 1.  Query
    j < bucket of a row sits at f = off + j.
    """
    dev = dst.device
    ks, imeta, dmeta = _sweep_args(ks, imeta, dmeta, mode, n_pad, m)
    _check(dst, "dst", torch.float64, dev, 1)
    _check(combined, "combined", torch.float64, dev, 3)
    _check(xt, "xt", torch.float64, dev, 1)
    _check(yt, "yt", torch.float64, dev, 1)
    _check(ks, "ks", torch.int32, dev, 1)
    _check(imeta, "imeta", torch.int32, dev, 2)
    _check(dmeta, "dmeta", torch.int32, dev, 2)
    if yt.shape != xt.shape:
        raise ValueError("xt and yt must have one length")
    K, ny, nx = combined.shape
    _launch("sweep_d5512_scatter", dev, dst.data_ptr(), dst.shape[0],
            combined.data_ptr(), K, ny, nx, xt.data_ptr(), yt.data_ptr(),
            xt.shape[0], ks.data_ptr(), imeta.data_ptr(), dmeta.data_ptr(),
            ks.shape[0], int(bucket), float(inv_scale), float(off_grid),
            mode, int(n_pad), int(m))
    return dst


def sweep_d5512_scatter_plain(dst, combined, xt, yt, ks, imeta, dmeta,
                              inv_scale, off_grid, bucket: int, mode: int,
                              n_pad: int = 0, m: int = 0) -> torch.Tensor:
    """Plain version of K2 (same function, any device); updates dst in place."""
    ks, imeta, dmeta = _sweep_args(ks, imeta, dmeta, mode, n_pad, m)
    dev = dst.device
    ks, imeta, dmeta = ks.long(), imeta.long(), dmeta.long()
    K = combined.shape[0]
    L = xt.shape[0]
    j = torch.arange(bucket, device=dev)[None, :]
    step = max(1, (1 << 16) // max(bucket, 1))
    for r0 in range(0, ks.shape[0], step):
        im, dm, kr = imeta[r0:r0 + step], dmeta[r0:r0 + step], ks[r0:r0 + step]
        if mode == 0:
            fd = dm[:, 3:4] + j
            w2d = dm[:, 1:2].clamp(min=1)
            d = dm[:, 0:1] + (fd // w2d) * dm[:, 2:3] + fd % w2d
            ok = j < dm[:, 4:5]
        else:
            fd = dm[:, 2:3] + j
            d = dm[:, 0:1] + (fd % m) * n_pad + dm[:, 1:2] + fd // m
            ok = j < dm[:, 3:4]
        f = im[:, 3:4] + j
        w2 = im[:, 2:3].clamp(min=1)
        i1 = im[:, 0:1] + f // w2
        i2 = im[:, 1:2] + f % w2
        k = kr[:, None].expand_as(f)
        ok = (ok & (j < im[:, 4:5]) & (d >= 0) & (d < dst.shape[0])
              & (k >= 0) & (k < K) & (i1 >= 0) & (i1 < L) & (i2 >= 0) & (i2 < L))
        i1, i2, k, d = (t[ok] for t in (i1, i2, k, d))
        qx = (xt[i1] - xt[i2]) * inv_scale + off_grid
        qy = (yt[i1] - yt[i2]) * inv_scale + off_grid
        dst.index_add_(0, d, _interp.interp2d_stack(combined, qx, qy, k))
    return dst
