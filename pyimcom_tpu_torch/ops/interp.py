"""
D5512 separable polynomial interpolation on PyTorch.

Counterpart of pyimcom_tpu/ops/interp.py.  The weights in each direction
are a fixed degree-9 polynomial of the fractional phase fh = x - floor(x) -
0.5, split into even and odd parts; interpolation contracts the 10x10 pixel
patch around each query with the row and column weights.  Queries whose
patch would leave the grid (valid iff 4 <= floor(q) < n - 5) return 0.

The gather forms (:func:`interp2d`, :func:`interp2d_stack`,
:func:`grid_interp`) are the contract and run in plain PyTorch.  The dense
entry :func:`interp2d_dense` -- the contract of the JAX package's TPU
kernel -- launches the hand-written CUDA kernel on a CUDA tensor and the
plain gather on a CPU tensor (ops/interp_cuda.py).  Only the D5512 family is ported; the
JAX package's banded-weight forms are a TPU workaround and are not.
"""

from __future__ import annotations

import numpy as np
import torch

# Degree-9 kernel coefficients (even/odd split), highest power of fh^2 first.
# Row k gives weights w[k] and w[9-k]:
#   e_k = polyval(EVEN[k], fh^2),  o_k = polyval(ODD[k], fh^2) * fh
#   w[k] = e_k + o_k,  w[9-k] = e_k - o_k
# These constants define the D5512 scheme (pyimcom_tpu/ops/interp.py:71-94).
D5512_EVEN = np.array([
    [+1.651881673372979740e-05, -3.145538007199505447e-04, +1.793518183780194427e-03,
     -2.904014557029917318e-03, +6.187591260980151433e-04],
    [-1.146756217210629335e-04, +2.883845374976550142e-03, -1.857047531896089884e-02,
     +3.147734488597204311e-02, -6.753293626461192439e-03],
    [+3.256838096371517067e-04, -9.702063770653997568e-03, +8.678848026470635524e-02,
     -1.659182651092198924e-01, +3.620560878249733799e-02],
    [-4.541830837949564726e-04, +1.494862093737218955e-02, -1.668775957435094937e-01,
     +5.879306056792649171e-01, -1.367845996704077915e-01],
    [+2.266560930061513573e-04, -7.815848920941316502e-03, +9.686607348538181506e-02,
     -4.505856722239036105e-01, +6.067135256905490381e-01],
])
D5512_ODD = np.array([
    [-3.486978652054735998e-06, +6.753750285320532433e-05, -3.871378836550175566e-04,
     +6.279918076641771273e-04, -1.338434614116611838e-04],
    [+3.121412120355294799e-05, -8.040343683015897672e-04, +5.209574765466357636e-03,
     -8.847326408846412429e-03, +1.898674086370833597e-03],
    [-1.243658986204533102e-04, +3.804930695189636097e-03, -3.434861846914529643e-02,
     +6.581033749134083954e-02, -1.436476114189205733e-02],
    [+2.894406669584551734e-04, -9.794291009695265532e-03, +1.104231510875857830e-01,
     -3.906954914039130755e-01, +9.092432925988773451e-02],
    [-4.336085507644610966e-04, +1.537862263741893339e-02, -1.925091434770601628e-01,
     +8.993141455798455697e-01, -1.213035309579723942e+00],
])

KERNEL_SIZE = 10
_LO = 4            # the patch starts at xi - 4
_HI_MARGIN = 5     # valid iff xi <= ngx - 6, i.e. xi < ngx - 5

# queries per gather chunk: bounds the (N, 10, 10) patch temporary to
# 2**15 * 100 doubles
_CHUNK = 1 << 15


def check_kern(kern: str) -> None:
    """Only the D5512 family is ported; any other raises."""
    if kern != "D5512":
        raise NotImplementedError(
            f"interpolation kernel {kern!r} is not ported to pyimcom_tpu_torch "
            f"(only 'D5512'; G4460 is listed in ROADMAP.md)")


def kernel_weights(fh: torch.Tensor) -> torch.Tensor:
    """D5512 weights (..., 10) for the fractional phase fh (...,)."""
    even = torch.as_tensor(D5512_EVEN, dtype=fh.dtype, device=fh.device)
    odd = torch.as_tensor(D5512_ODD, dtype=fh.dtype, device=fh.device)
    fh2 = fh * fh
    p = torch.stack([fh2 ** 4, fh2 ** 3, fh2 ** 2, fh2, torch.ones_like(fh2)],
                    dim=-1)
    e = p @ even.T
    o = (p @ odd.T) * fh[..., None]
    return torch.cat([e + o, (e - o).flip(-1)], dim=-1)


def _split_query(x: torch.Tensor, ng: int):
    """Clamped integer base index, fractional phase and validity mask (a NaN
    query is invalid, and its base index the lowest)."""
    xf = torch.floor(x)
    valid = (xf >= _LO) & (xf < ng - _HI_MARGIN)
    fh = x - xf - 0.5
    xi = xf.nan_to_num(nan=float(_LO)).clamp(_LO, ng - _HI_MARGIN - 1).to(torch.int64)
    return xi, fh, valid


def _gather_interp(flat: torch.Tensor, base: torch.Tensor, ny: int, nx: int,
                   x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Interpolate at N points, point n reading the (ny, nx) image that starts
    at flat[base[n]]: a gather of the ten 10-wide patch rows and two
    contractions."""
    out = torch.zeros(x.shape, dtype=flat.dtype, device=flat.device)
    flat = flat.contiguous()
    # every 10-wide run of the flat buffer, as rows of a strided view
    runs = flat.as_strided((flat.numel() - KERNEL_SIZE + 1, KERNEL_SIZE), (1, 1))
    row_offs = torch.arange(KERNEL_SIZE, device=flat.device) * nx
    for s in range(0, x.shape[0], _CHUNK):
        sl = slice(s, s + _CHUNK)
        xi, fhx, vx = _split_query(x[sl], nx)
        yi, fhy, vy = _split_query(y[sl], ny)
        wx = kernel_weights(fhx)
        wy = kernel_weights(fhy)
        start = base[sl] + (yi - _LO) * nx + (xi - _LO)
        patch = runs[start[:, None] + row_offs]                # (n, 10, 10)
        val = (torch.bmm(patch, wx[:, :, None])[..., 0] * wy).sum(dim=-1)
        out[sl] = torch.where(vx & vy, val, torch.zeros_like(val))
    return out


def interp2d(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
             kern: str = "D5512") -> torch.Tensor:
    """Interpolate one (ny, nx) image at points x, y (N,) -> (N,)."""
    check_kern(kern)
    ny, nx = image.shape
    base = torch.zeros(x.shape, dtype=torch.int64, device=image.device)
    return _gather_interp(image.reshape(-1), base, ny, nx, x, y)


def interp2d_stack(images: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                   which: torch.Tensor, kern: str = "D5512") -> torch.Tensor:
    """Each query reads its own image of a (K, ny, nx) stack: which (N,)."""
    check_kern(kern)
    _K, ny, nx = images.shape
    base = which.to(torch.int64) * (ny * nx)
    return _gather_interp(images.reshape(-1), base, ny, nx, x, y)


def grid_interp(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                kern: str = "D5512") -> torch.Tensor:
    """Separable-grid interpolation: image (ny, nx), x (P, nxo), y (P, nyo)
    -> (P, nyo, nxo), evaluated on the outer product grid of each row."""
    check_kern(kern)
    ny, nx = image.shape
    P, nxo = x.shape
    nyo = y.shape[1]
    xi, fhx, vx = _split_query(x, nx)
    yi, fhy, vy = _split_query(y, ny)
    wx = kernel_weights(fhx) * vx[..., None]      # invalid -> zero weights
    wy = kernel_weights(fhy) * vy[..., None]
    offs = torch.arange(KERNEL_SIZE, device=image.device) - _LO
    rows = image[yi[:, :, None] + offs]                             # (P, nyo, 10, nx)
    H = torch.einsum("pyin,pyi->pyn", rows, wy)                      # (P, nyo, nx)
    ix = (xi[:, :, None] + offs).reshape(P, 1, nxo * KERNEL_SIZE)
    cols = torch.gather(H, 2, ix.expand(P, nyo, nxo * KERNEL_SIZE))
    return torch.einsum("pyxj,pxj->pyx",
                        cols.reshape(P, nyo, nxo, KERNEL_SIZE), wx)


def interp2d_dense(images: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                   kern: str = "D5512", *, lattice_row: int = 0) -> torch.Tensor:
    """
    Interpolate a batch of images at per-image query sets: images (R, ny,
    nx), x, y (R, Nq) -> (R, Nq); 0 off-grid.

    The contract of the JAX package's TPU interpolation kernel, without its
    (8, 128) alignment rule.  A CUDA tensor launches kernel K1;
    a CPU tensor runs its plain gather version.  `lattice_row` > 0 tells K1
    that each image's queries are a lattice in row-major order with rows of
    that many points (it groups neighbouring points; the result is the
    same).
    """
    from . import interp_cuda

    check_kern(kern)
    if images.is_cuda:
        return interp_cuda.interp_d5512_dense(images, x, y, lattice_row=lattice_row)
    if images.device.type != "cpu":
        raise ValueError(f"interp2d_dense: unsupported device {images.device}")
    return interp_cuda.interp_d5512_dense_plain(images, x, y)
