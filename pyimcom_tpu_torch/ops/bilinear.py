"""
The destriping bilinear pair on PyTorch: the 4-tap (gain-weighted) gather
and its exact adjoint.

Counterpart of pyimcom_tpu/ops/bilinear.py and of the weighted gather in
pyimcom_tpu/ops/destripe_device.py.  The contract is the JAX package's
``_taps``: a query (xf, yf) is in bounds iff 0 <= floor(xf) < nx - 1 and
0 <= floor(yf) < ny - 1, and reads the four pixels around (floor(xf),
floor(yf)) with bilinear weights w_k; with a gain map g the taps are
weighted and normalised, sum_k w_k g_k v_k / norm with norm = sum_k w_k g_k
(norm <= 0 taken as 1).  Out of bounds the value is 0.  A NaN position is
out of bounds: it gives 0 and adds nothing to the adjoint (the JAX package
gives NaN there).  The positions are float64, or float32 (pair maps stored
at half the width): float32 positions are widened to float64 first, which
is exact, so both compute in float64 on the same numbers.

:func:`bilinear_gather` and :func:`bilinear_scatter_adjoint` launch the
hand-written CUDA kernels K3 and K4 on a CUDA tensor (ops/bilinear_cuda.py)
and run the plain versions on a CPU tensor; any other device raises.
:class:`BilinearGather` is the gather under autograd: its backward is the
adjoint with respect to the image.
"""

from __future__ import annotations

import torch


def in_bounds(xf: torch.Tensor, yf: torch.Tensor, shape) -> torch.Tensor:
    """The queries that read a (ny, nx) = `shape` image (bool, xf's shape),
    on any device."""
    ny, nx = shape
    x0, y0 = torch.floor(xf), torch.floor(yf)
    return (x0 >= 0) & (x0 < nx - 1) & (y0 >= 0) & (y0 < ny - 1)


def _taps(xf: torch.Tensor, yf: torch.Tensor, nx: int, ny: int):
    """Flat indices (4, N) of the taps, their weights (4, N) and the in-bounds
    mask (N,) of the queries xf, yf (N,).  An out-of-bounds query takes
    pixel (0, 0) with weights (1, 0, 0, 0), finite whatever its position,
    so that a gradient through the discarded value stays 0."""
    x0, y0 = torch.floor(xf), torch.floor(yf)
    inb = in_bounds(xf, yf, (ny, nx))
    x0 = torch.where(inb, x0, 0.0)
    y0 = torch.where(inb, y0, 0.0)
    fx = torch.where(inb, xf - x0, 0.0)
    fy = torch.where(inb, yf - y0, 0.0)
    i00 = y0.to(torch.int64) * nx + x0.to(torch.int64)
    idx = torch.stack([i00, i00 + 1, i00 + nx, i00 + nx + 1])
    w = torch.stack([(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy])
    return idx, w, inb


def _wide(pos: torch.Tensor) -> torch.Tensor:
    """Positions as float64 (float32 widened, exactly)."""
    return pos if pos.dtype == torch.float64 else pos.to(torch.float64)


def _gain_weights(w, idx, g_eff):
    """The gain-weighted weights w_k g_k (4, N) and their norm (N,)."""
    wg = w * g_eff.reshape(-1)[idx]
    norm = wg[0] + wg[1] + wg[2] + wg[3]
    return wg, torch.where(norm > 0, norm, 1.0)


def bilinear_gather_plain(image: torch.Tensor, xf: torch.Tensor, yf: torch.Tensor,
                          g_eff: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K3 (same function, any device, differentiable with
    respect to the image): image (ny, nx), xf, yf (any shape) -> xf's
    shape; float32 positions are widened to float64 first)."""
    ny, nx = image.shape
    idx, w, inb = _taps(_wide(xf).reshape(-1), _wide(yf).reshape(-1), nx, ny)
    v = image.reshape(-1)[idx]
    if g_eff is None:
        out = w[0] * v[0] + w[1] * v[1] + w[2] * v[2] + w[3] * v[3]
    else:
        wg, norm = _gain_weights(w, idx, g_eff)
        out = (wg[0] * v[0] + wg[1] * v[1] + wg[2] * v[2] + wg[3] * v[3]) / norm
    return torch.where(inb, out, 0.0).reshape(xf.shape)


def bilinear_scatter_adjoint_plain(values: torch.Tensor, xf: torch.Tensor, yf: torch.Tensor,
                                   shape, g_eff: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K4 (same function, any device): each in-bounds value
    added into its four taps of a (ny, nx) = `shape` grid with
    ``index_add_``; float32 positions are widened to float64 first)."""
    ny, nx = shape
    idx, w, inb = _taps(_wide(xf).reshape(-1), _wide(yf).reshape(-1), nx, ny)
    idx, w, v = idx[:, inb], w[:, inb], values.reshape(-1)[inb]
    if g_eff is not None:
        w, norm = _gain_weights(w, idx, g_eff)
        v = v / norm
    out = torch.zeros(ny * nx, dtype=values.dtype, device=values.device)
    out.index_add_(0, idx.reshape(-1), (v * w).reshape(-1))
    return out.reshape(ny, nx)


def _device_route(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (the kernel), False for a CPU tensor (the plain
    version); any other device raises."""
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return False


def bilinear_gather(image: torch.Tensor, xf: torch.Tensor, yf: torch.Tensor,
                    g_eff: torch.Tensor | None = None, *,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """The (gain-weighted) gather at (xf, yf); with `out`, added into it in
    place.  K3 on a CUDA tensor, the plain version on a CPU tensor."""
    from . import bilinear_cuda

    if _device_route(image, "bilinear_gather"):
        return bilinear_cuda.bilinear_gather(image, xf, yf, g_eff, out=out)
    val = bilinear_gather_plain(image, xf, yf, g_eff)
    return val if out is None else out.add_(val)


def bilinear_scatter_adjoint(values: torch.Tensor, xf: torch.Tensor, yf: torch.Tensor,
                             shape, g_eff: torch.Tensor | None = None, *,
                             out: torch.Tensor | None = None, plan=None) -> torch.Tensor:
    """The exact adjoint of :func:`bilinear_gather` with respect to the
    image; with `out`, added into it in place.  K4 on a CUDA tensor (over
    `plan`, K4's plan of these positions, where one is given:
    bilinear_cuda.build_adjoint_plan), the plain version on a CPU tensor,
    which takes no plan and ignores one."""
    from . import bilinear_cuda

    if _device_route(values, "bilinear_scatter_adjoint"):
        return bilinear_cuda.bilinear_scatter_adjoint(values, xf, yf, shape, g_eff, out=out,
                                                      plan=plan)
    val = bilinear_scatter_adjoint_plain(values, xf, yf, shape, g_eff)
    return val if out is None else out.add_(val)


class BilinearGather(torch.autograd.Function):
    """
    ``BilinearGather.apply(image, xf, yf, g_eff=None, acc=None, plan=None)``:
    the gather of `image` (ny, nx) at (xf, yf) (K3), added in place into
    `acc` where one is given (and returned).  The positions are float64 or
    both float32.  The backward is K4 with respect to the image (over
    `plan`, K4's plan of the positions, where given), and the identity with
    respect to `acc`; the positions and the gain take no gradient.  It saves
    only its inputs xf, yf and g_eff and the plan, no output.
    """

    @staticmethod
    def forward(ctx, image, xf, yf, g_eff=None, acc=None, plan=None):
        ctx.shape, ctx.with_acc, ctx.plan = tuple(image.shape), acc is not None, plan
        ctx.save_for_backward(xf, yf, g_eff)
        if acc is None:
            return bilinear_gather(image, xf, yf, g_eff)
        ctx.mark_dirty(acc)
        return bilinear_gather(image, xf, yf, g_eff, out=acc)

    @staticmethod
    def backward(ctx, grad):
        xf, yf, g_eff = ctx.saved_tensors
        grad_image = None
        if ctx.needs_input_grad[0]:
            grad_image = bilinear_scatter_adjoint(grad.contiguous(), xf, yf, ctx.shape, g_eff,
                                                  plan=ctx.plan)
        grad_acc = grad if ctx.with_acc and ctx.needs_input_grad[4] else None
        return grad_image, None, None, None, grad_acc, None
