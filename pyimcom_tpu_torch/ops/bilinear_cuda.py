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
device only, the positions xf, yf f64 or both f32, and raises on anything
else; it launches on the current stream, allocates its output with torch,
checks the launch and counts it in ``launches``, the float32-position forms
under their own names (``bilinear_gather.f32``,
``bilinear_scatter_adjoint.f32``).  Those forms widen each position to
float64 as they read it, so they compute what the f64 forms compute on the
widened positions.  The plain versions are in ``ops/bilinear.py``.

K4 takes its queries in tiles of their grid: a 2-D `xf` is the (qny, qnx)
query grid (a destripe pair passes the target's pixel grid), any other
shape one row.  A tile whose taps' bounding box outgrows the kernel's
shared-memory box adds straight into device memory and counts itself in
:func:`global_tiles`; :func:`predict_global_tiles` computes the same count
in plain torch.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .interp_cuda import _check

# launches of each kernel since the last reset_launch_counts(); incremented
# by the wrappers where they launch, and nowhere else; a form on float32
# positions counts under its kernel's name + ".f32"
launches = {"bilinear_gather": 0, "bilinear_scatter_adjoint": 0,
            "bilinear_gather.f32": 0, "bilinear_scatter_adjoint.f32": 0}
# the position dtypes a kernel takes, and the suffix of their form's C entry
POSITION_FORMS = {torch.float64: "", torch.float32: "_f32"}

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_GATHER_ARGS = (_p, _p, _i, _i, _p, _p, _ll, _p, _i, _p)
_ADJOINT_ARGS = (_p, _p, _i, _i, _p, _p, _i, _i, _p, _p, _p)
_SIGNATURES = {"bilinear_gather": _GATHER_ARGS, "bilinear_gather_f32": _GATHER_ARGS,
               "bilinear_scatter_adjoint": _ADJOINT_ARGS,
               "bilinear_scatter_adjoint_f32": _ADJOINT_ARGS}
# K4's tiling, as csrc/bilinear.cu has it: (rows, columns) of queries a tile
# of a 2-D query grid and of one row, and the f64 slots of a tile's
# accumulator box in shared memory
ADJOINT_TILE, ADJOINT_ROW_TILE, ADJOINT_BOX_CAP = (32, 32), (1, 1024), 3072


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def _launch(name: str, pos_dtype, device: torch.device, *args) -> None:
    """Launch kernel `name` in its form for positions of `pos_dtype`."""
    suffix = POSITION_FORMS[pos_dtype]
    entry = name + suffix
    fn = getattr(_build.library("bilinear"), entry)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[entry]
        fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {entry} failed to launch: cudaError {err}")
    launches[name + suffix.replace("_", ".")] += 1


def _check_pair(shape, xf, yf, g_eff, dev):
    """Check the positions (f64, or both f32) and the gain; returns (ny, nx)."""
    pos = xf.dtype if xf.dtype in POSITION_FORMS else torch.float64
    _check(xf, "xf", pos, dev, xf.dim())
    _check(yf, "yf", pos, dev, yf.dim())
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


def query_grid(xf: torch.Tensor) -> tuple[int, int]:
    """K4's (qny, qnx) query grid of positions `xf`: its own shape if 2-D,
    its last axis by the rest if more, one row if 1-D."""
    if xf.dim() >= 2:
        return xf.numel() // max(xf.shape[-1], 1), xf.shape[-1]
    return 1, xf.numel()


def adjoint_tile(qny: int) -> tuple[int, int]:
    """(rows, columns) of queries in a K4 tile of a grid of `qny` rows."""
    return ADJOINT_ROW_TILE if qny == 1 else ADJOINT_TILE


def predict_global_tiles(xf: torch.Tensor, yf: torch.Tensor, shape) -> int:
    """The K4 tiles that take the global route on these positions, in plain
    torch (any device): a tile with a query in bounds whose taps' bounding
    box holds more than ADJOINT_BOX_CAP pixels."""
    from .bilinear import in_bounds

    qny, qnx = query_grid(xf)
    th, tw = adjoint_tile(qny)
    ty, tx = -(-qny // th), -(-qnx // tw)
    inb = in_bounds(xf, yf, shape).reshape(qny, qnx)
    big = float(2 ** 31)

    def per_tile(a, fill):
        full = a.new_full((ty * th, tx * tw), fill)
        full[:qny, :qnx] = a
        return full.reshape(ty, th, tx, tw).transpose(1, 2).reshape(ty, tx, th * tw)

    fx = torch.floor(xf.double()).reshape(qny, qnx)
    fy = torch.floor(yf.double()).reshape(qny, qnx)
    x_lo = per_tile(torch.where(inb, fx, big), big).amin(-1)
    x_hi = per_tile(torch.where(inb, fx, -big), -big).amax(-1)
    y_lo = per_tile(torch.where(inb, fy, big), big).amin(-1)
    y_hi = per_tile(torch.where(inb, fy, -big), -big).amax(-1)
    live = per_tile(inb, False).any(-1)
    box = (x_hi - x_lo + 2) * (y_hi - y_lo + 2)
    return int((live & (box > ADJOINT_BOX_CAP)).sum())


def _global_counter(device: torch.device) -> torch.Tensor:
    c = _global_counters.get(device)
    if c is None:
        c = _global_counters[device] = torch.zeros(1, dtype=torch.int64, device=device)
    return c


_global_counters: dict[torch.device, torch.Tensor] = {}


def global_tiles(device) -> int:
    """K4 tiles that took the global route (their box outgrew shared memory)
    on `device` since the last :func:`reset_global_tiles`."""
    return int(_global_counter(torch.device(device)).item())


def reset_global_tiles() -> None:
    for c in _global_counters.values():
        c.zero_()


def bilinear_gather(image: torch.Tensor, xf: torch.Tensor, yf: torch.Tensor,
                    g_eff: torch.Tensor | None = None, *,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """
    K3: image (ny, nx) f64, xf, yf (any shape, one shape; f64, or both
    f32) CUDA -> the f64 bilinear values at (xf, yf), 0 out of bounds or at
    a NaN position; with
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
    _launch("bilinear_gather", xf.dtype, dev, image.data_ptr(), _ptr(g_eff), ny, nx,
            xf.data_ptr(), yf.data_ptr(), xf.numel(), result.data_ptr(), int(out is not None))
    return result


def bilinear_scatter_adjoint(values: torch.Tensor, xf: torch.Tensor, yf: torch.Tensor,
                             shape, g_eff: torch.Tensor | None = None, *,
                             out: torch.Tensor | None = None) -> torch.Tensor:
    """
    K4: the exact adjoint of K3 with respect to the image: values f64 and
    xf, yf (f64, or both f32), one shape, CUDA -> (ny, nx) = `shape` f64,
    each in-bounds value added into its four taps with K3's weights (and
    gain).  The queries are tiled on their grid (:func:`query_grid`); the
    sums are taken with atomics, in no fixed order.  With `out` ((ny, nx)
    f64) the contributions are added into it in place, and it is returned.
    """
    dev = values.device
    _check(values, "values", torch.float64, dev, values.dim())
    ny, nx = _check_pair(tuple(shape), xf, yf, g_eff, dev)
    if values.shape != xf.shape:
        raise ValueError(f"values must have xf's shape {tuple(xf.shape)}, got "
                         f"{tuple(values.shape)}")
    if out is None:
        out = torch.zeros((ny, nx), dtype=torch.float64, device=dev)
    else:
        _check(out, "out", torch.float64, dev, 2)
        if tuple(out.shape) != (ny, nx):
            raise ValueError(f"out must have the image's shape {(ny, nx)}, got "
                             f"{tuple(out.shape)}")
    if xf.numel() == 0:
        return out
    qny, qnx = query_grid(xf)
    if qny >= 2 ** 31 or qnx >= 2 ** 31:
        raise ValueError("K4 indexes the query grid's rows and columns with int32")
    _launch("bilinear_scatter_adjoint", xf.dtype, dev, values.data_ptr(), _ptr(g_eff), ny, nx,
            xf.data_ptr(), yf.data_ptr(), qny, qnx, out.data_ptr(),
            _global_counter(dev).data_ptr())
    return out
