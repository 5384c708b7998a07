"""
Separable polynomial interpolation (D5512 and G4460) on PyTorch.

Counterpart of pyimcom_tpu/ops/interp.py.  The weights in each direction
are a fixed degree-9 polynomial of the fractional phase fh = x - floor(x) -
0.5, split into even and odd parts; interpolation contracts the k x k pixel
patch around each query with the row and column weights.  Two families are
registered (KERNEL_FAMILIES): D5512, 10 taps whose patch starts at xi - 4
(valid iff 4 <= floor(q) < n - 5), and the faster G4460, 8 taps from xi - 3
(valid iff 3 <= floor(q) < n - 4).  Queries whose patch would leave the
grid return 0.

The gather forms (:func:`interp2d`, :func:`interp2d_stack`,
:func:`grid_interp`) are the contract and run in plain PyTorch.  The dense
entry :func:`interp2d_dense` -- the contract of the JAX package's TPU
kernel -- launches the family's hand-written CUDA kernel on a CUDA tensor
and the plain gather on a CPU tensor (ops/interp_cuda.py).  The JAX
package's banded-weight forms are a TPU workaround and are not ported.
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

# G4460: 8x8 footprint, the JAX package's L2-optimal band-limited design
# (pyimcom_tpu/ops/interp.py:99-118).  Row k gives taps w[k] and w[7-k].
G4460_EVEN = np.array([
    [-1.945235823911159925e-05, +1.055874006170703754e-03, -8.118995675262492134e-03,
     +1.453840359289597893e-02, -3.143522062829661335e-03],
    [+8.999088401166260235e-05, -5.148137838987351493e-03, +6.069481712095783216e-02,
     -1.235960532055178779e-01, +2.718540716184886588e-02],
    [-1.540666237308310749e-04, +9.123606051920359755e-03, -1.334507380042637137e-01,
     +5.336865231190287551e-01, -1.252224819511615628e-01],
    [+8.351472709485021652e-05, -5.031103870555608815e-03, +8.087359556892606549e-02,
     -4.246267565082386120e-01, +6.011801467479378491e-01],
])
G4460_ODD = np.array([
    [+7.260754694387638895e-06, -2.904202176384821071e-04, +2.238241587784505285e-03,
     -4.005111027206044276e-03, +8.423052633873124011e-04],
    [-4.631632696889089514e-05, +1.991059241797971720e-03, -2.378440273076087505e-02,
     +4.853753882315355733e-02, -1.053588105750352319e-02],
    [+1.308916996808606444e-04, -5.896228276277161624e-03, +8.761981577498251239e-02,
     -3.533315658835169404e-01, +8.255813013281140811e-02],
    [-2.118650110726590574e-04, +9.766034727710315444e-03, -1.596037936464457796e-01,
     +8.453409395243187685e-01, -1.200891120242346455e+00],
])

KERNEL_SIZE = 10
_LO = 4            # D5512: the patch starts at xi - 4
_HI_MARGIN = 5     # D5512: valid iff xi <= ngx - 6, i.e. xi < ngx - 5

# registry: kern -> (EVEN, ODD, size, lo, hi_margin); the patch spans
# [xi - lo, xi - lo + size), and a query is valid iff lo <= xi < ng - hi_margin
KERNEL_FAMILIES = {
    "D5512": (D5512_EVEN, D5512_ODD, 10, 4, 5),
    "G4460": (G4460_EVEN, G4460_ODD, 8, 3, 4),
}

# queries per gather chunk: bounds the (N, k, k) patch temporary to
# 2**15 * 100 doubles
_CHUNK = 1 << 15


def check_kern(kern: str) -> None:
    """Raise ValueError for an interpolation family outside KERNEL_FAMILIES."""
    if kern not in KERNEL_FAMILIES:
        raise ValueError(f"unknown interpolation kernel {kern!r}; choose from "
                         f"{sorted(KERNEL_FAMILIES)}")


def kernel_weights(fh: torch.Tensor, kern: str = "D5512") -> torch.Tensor:
    """The family's weights (..., size) for the fractional phase fh (...,)."""
    even_np, odd_np = KERNEL_FAMILIES[kern][:2]
    even = torch.as_tensor(even_np, dtype=fh.dtype, device=fh.device)
    odd = torch.as_tensor(odd_np, dtype=fh.dtype, device=fh.device)
    fh2 = fh * fh
    p = torch.stack([fh2 ** 4, fh2 ** 3, fh2 ** 2, fh2, torch.ones_like(fh2)],
                    dim=-1)
    e = p @ even.T
    o = (p @ odd.T) * fh[..., None]
    return torch.cat([e + o, (e - o).flip(-1)], dim=-1)


def _split_query(x: torch.Tensor, ng: int, kern: str = "D5512"):
    """Clamped integer base index, fractional phase and validity mask (a NaN
    query is invalid, and its base index the lowest)."""
    lo, hi = KERNEL_FAMILIES[kern][3:]
    xf = torch.floor(x)
    valid = (xf >= lo) & (xf < ng - hi)
    fh = x - xf - 0.5
    xi = xf.nan_to_num(nan=float(lo)).clamp(lo, ng - hi - 1).to(torch.int64)
    return xi, fh, valid


def _gather_interp(flat: torch.Tensor, base: torch.Tensor, ny: int, nx: int,
                   x: torch.Tensor, y: torch.Tensor, kern: str) -> torch.Tensor:
    """Interpolate at N points, point n reading the (ny, nx) image that starts
    at flat[base[n]]: a gather of the family's patch rows and two
    contractions."""
    size, lo = KERNEL_FAMILIES[kern][2:4]
    out = torch.zeros(x.shape, dtype=flat.dtype, device=flat.device)
    flat = flat.contiguous()
    # every size-wide run of the flat buffer, as rows of a strided view
    runs = flat.as_strided((flat.numel() - size + 1, size), (1, 1))
    row_offs = torch.arange(size, device=flat.device) * nx
    for s in range(0, x.shape[0], _CHUNK):
        sl = slice(s, s + _CHUNK)
        xi, fhx, vx = _split_query(x[sl], nx, kern)
        yi, fhy, vy = _split_query(y[sl], ny, kern)
        wx = kernel_weights(fhx, kern)
        wy = kernel_weights(fhy, kern)
        start = base[sl] + (yi - lo) * nx + (xi - lo)
        patch = runs[start[:, None] + row_offs]                # (n, size, size)
        val = (torch.bmm(patch, wx[:, :, None])[..., 0] * wy).sum(dim=-1)
        out[sl] = torch.where(vx & vy, val, torch.zeros_like(val))
    return out


def interp2d(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
             kern: str = "D5512") -> torch.Tensor:
    """Interpolate one (ny, nx) image at points x, y (N,) -> (N,)."""
    check_kern(kern)
    ny, nx = image.shape
    base = torch.zeros(x.shape, dtype=torch.int64, device=image.device)
    return _gather_interp(image.reshape(-1), base, ny, nx, x, y, kern)


def interp2d_stack(images: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                   which: torch.Tensor, kern: str = "D5512") -> torch.Tensor:
    """Each query reads its own image of a (K, ny, nx) stack: which (N,)."""
    check_kern(kern)
    _K, ny, nx = images.shape
    base = which.to(torch.int64) * (ny * nx)
    return _gather_interp(images.reshape(-1), base, ny, nx, x, y, kern)


def grid_interp(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                kern: str = "D5512") -> torch.Tensor:
    """Separable-grid interpolation: image (ny, nx), x (P, nxo), y (P, nyo)
    -> (P, nyo, nxo), evaluated on the outer product grid of each row.  A
    stack of images (P, ny, nx) gives each row its own image (the batched
    Piff draw); each row's arithmetic is that of a single image."""
    check_kern(kern)
    size, lo = KERNEL_FAMILIES[kern][2:4]
    ny, nx = image.shape[-2:]
    P, nxo = x.shape
    nyo = y.shape[1]
    xi, fhx, vx = _split_query(x, nx, kern)
    yi, fhy, vy = _split_query(y, ny, kern)
    wx = kernel_weights(fhx, kern) * vx[..., None]      # invalid -> zero weights
    wy = kernel_weights(fhy, kern) * vy[..., None]
    offs = torch.arange(size, device=image.device) - lo
    if image.dim() == 3:
        pick = torch.arange(P, device=image.device)[:, None, None]
        rows = image[pick, yi[:, :, None] + offs]                   # (P, nyo, size, nx)
    else:
        rows = image[yi[:, :, None] + offs]                         # (P, nyo, size, nx)
    H = torch.einsum("pyin,pyi->pyn", rows, wy)                      # (P, nyo, nx)
    ix = (xi[:, :, None] + offs).reshape(P, 1, nxo * size)
    cols = torch.gather(H, 2, ix.expand(P, nyo, nxo * size))
    return torch.einsum("pyxj,pxj->pyx", cols.reshape(P, nyo, nxo, size), wx)


def interp2d_dense(images: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                   kern: str = "D5512", *, lattice_row: int = 0,
                   segments=None) -> torch.Tensor:
    """
    Interpolate a batch of images at per-image query sets: images (R, ny,
    nx), x, y (R, Nq) -> (R, Nq); 0 off-grid.

    The contract of the JAX package's TPU interpolation kernel, without its
    (8, 128) alignment rule.  A CUDA tensor launches the family's kernel K1
    (10 or 8 taps); a CPU tensor runs its plain gather version.
    `lattice_row` > 0 tells K1 that each image's queries are a lattice in
    row-major order with rows of that many points (it groups neighbouring
    points; the result is the same).  `segments`
    (:class:`interp_cuda.CanvasSegments`) tells it that one image's queries
    are points of a canvas lattice, laid out in those segments (it takes
    them a tile of the lattice at a time; the result is the same).  The
    plain version ignores both.
    """
    from . import interp_cuda

    check_kern(kern)
    if images.is_cuda:
        return interp_cuda.interp_dense(images, x, y, kern, lattice_row=lattice_row,
                                        segments=segments)
    if images.device.type != "cpu":
        raise ValueError(f"interp2d_dense: unsupported device {images.device}")
    return interp_cuda.interp_dense_plain(images, x, y, kern)
