"""
Analytic mini-IMCOM interpolation for Gaussian-PSF mosaics, on a device.

Counterpart of pyimcom_tpu/meta/ginterp.py (reference
src/pyimcom/meta/ginterp.py).  :func:`InterpMatrix` is a host copy (NumPy
and one SciPy Cholesky a call); :func:`MultiInterp` computes the weights on
the host and runs its tap gather -- the O(N^2 NN layers) work -- as torch
gathers on an explicit device, the card by default.

Because the coadded mosaic has a known Gaussian PSF on a regular grid, the
IMCOM system matrix A and target vectors b have closed Gaussian forms, so the
deconvolve-shear-reconvolve-resample weights come from a single small
Cholesky solve per fractional-offset set instead of a full per-stamp IMCOM
run.  Corner blending keeps the weights continuous across pixel cells.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import torch

from ..device import resolve_device


def InterpMatrix(Rsearch, samp, x_out, y_out, Cov, epsilon=1.0e-7, stest=1):
    """
    Reconvolution + interpolation matrix for Gaussian-PSF input.

    Parameters
    ----------
    Rsearch : search radius from cell corners, in input pixels.
    samp : input sampling rate (samples per PSF FWHM).
    x_out, y_out : (Npts,) fractional pixel positions in [0, 1].
    Cov : [Cxx, Cxy, Cyy] extra-smoothing covariance (input pixel^2).
    epsilon : Tikhonov-style regularization strength.
    stest : compute U/Sigma diagnostics every stest-th point.

    Returns
    -------
    posx, posy : (NN,) int16 offsets of contributing input pixels.
    T : (Npts, NN) weights.
    U : fractional squared leakage at the sampled points.
    Sigma : noise amplification at the sampled points.
    """
    R = np.sqrt(np.ceil(Rsearch ** 2) + 0.01)
    N = int(np.ceil(R) + 1) * 2
    sigma = samp / np.sqrt(8 * np.log(2))
    Cxx, Cxy, Cyy = (float(c) for c in Cov)

    ax = np.linspace(-(N // 2) + 1, N // 2, N)
    posx, posy = np.meshgrid(ax, ax)
    posx = posx.ravel()
    posy = posy.ravel()
    keep = (np.abs(posx - 0.5) - 0.5) ** 2 + (np.abs(posy - 0.5) - 0.5) ** 2 <= R ** 2
    posx = posx[keep]
    posy = posy[keep]
    NN = posx.size

    # Gaussian-overlap system matrix and its regularized version (vectorized)
    ddx = posx[:, None] - posx[None, :]
    ddy = posy[:, None] - posy[None, :]
    A = np.exp(-(ddx ** 2 + ddy ** 2) / (4.0 * sigma ** 2))
    sige = np.sqrt(0.5)
    Ad = A + epsilon * np.exp(-(ddx ** 2 + ddy ** 2) / (4.0 * sige ** 2))

    def target_vec(sig0, scale):
        """Target overlaps b for smoothing covariance added to a width-sig0
        base, using the complete-the-square separable form."""
        detCT = (2 * sig0 ** 2 + Cxx) * (2 * sig0 ** 2 + Cyy) - Cxy ** 2
        iCTxx = (2 * sig0 ** 2 + Cyy) / detCT
        iCTxy = -Cxy / detCT
        iCTyy = (2 * sig0 ** 2 + Cxx) / detCT
        a_ = np.sqrt((iCTxx - iCTxy ** 2 / iCTyy) / 2.0)
        c_ = np.sqrt(iCTyy / 2.0)
        m_ = iCTxy / iCTyy
        du = (a_ * posx)[:, None] - (a_ * x_out)[None, :]
        dv = (c_ * (posy + m_ * posx))[:, None] - (c_ * (y_out + m_ * x_out))[None, :]
        return scale * 2 * sig0 ** 2 / np.sqrt(detCT) * np.exp(-(du ** 2 + dv ** 2))

    b = target_vec(sigma, 1.0)
    bp = b + target_vec(sige, epsilon)

    ratio_sqrtdet = np.sqrt((sigma ** 2 + Cxx) * (sigma ** 2 + Cyy) - Cxy ** 2) / sigma ** 2

    # corner-blended solves: one Cholesky (identical submatrix at each corner)
    TT = np.zeros_like(b)
    corners = [(0.0, 0.0), (1.0, 0.0), (0.0, 1.0), (1.0, 1.0)]
    weights = [(1 - x_out) * (1 - y_out), x_out * (1 - y_out),
               (1 - x_out) * y_out, x_out * y_out]
    cs = None
    for (xc, yc), w in zip(corners, weights):
        g = np.nonzero((posx - xc) ** 2 + (posy - yc) ** 2 <= R ** 2)[0]
        if cs is None:
            cs = scipy.linalg.cho_factor(Ad[np.ix_(g, g)])
        TT[g, :] += scipy.linalg.cho_solve(cs, bp[g, :], check_finite=False) * w[None, :]

    T = TT.T / np.sum(TT, axis=0)[:, None]
    U = 1.0 / ratio_sqrtdet + np.sum((T[::stest] @ A - 2 * b[:, ::stest].T) * T[::stest], axis=1)
    Sigma = np.sum(T[::stest] ** 2, axis=1)
    return (np.round(posx).astype(np.int16), np.round(posy).astype(np.int16),
            T, U, Sigma)


def MultiInterp(in_array, in_mask, out_size, out_origin, out_transform,
                Rsearch, samp, Cov, epsilon=1.0e-7, stest=1, blocksize=393216,
                device="cuda"):
    """
    Interpolate a (possibly multi-layer) mosaic onto an affine-mapped output
    grid with extra smoothing; returns (out_array, out_mask, Umax, Smax) as
    NumPy arrays and floats.

    x_in = T[0,0] x_out + T[0,1] y_out + origin[0] (same for y); both 0-based.

    For each block of output pixels the host builds the weights
    (:func:`InterpMatrix`); the mosaic and its mask live on `device`, where
    :func:`gather_taps` accumulates the taps of every layer at once.  The
    sum is kept in the mosaic's dtype and rounded after every tap, in the
    JAX package's order, so that a float32 mosaic gives the same float32
    result.
    """
    dev = resolve_device(device)
    is3D = in_array.ndim == 3
    arr3 = np.asarray(in_array if is3D else in_array[None])
    nlayer = arr3.shape[0]
    ny_in, nx_in = arr3.shape[-2:]
    ny, nx = out_size

    image = torch.as_tensor(arr3, device=dev).reshape(nlayer, -1)
    mask = torch.as_tensor(np.asarray(in_mask, dtype=bool), device=dev).reshape(-1)
    out_array = torch.zeros((nlayer, ny * nx), dtype=image.dtype, device=dev)
    out_mask = torch.ones(ny * nx, dtype=torch.bool, device=dev)
    Umax = Smax = 0.0

    for istart in range(0, ny * nx, blocksize):
        ngroup = min(blocksize, ny * nx - istart)
        pix = np.arange(istart, istart + ngroup)
        y_out = (pix // nx).astype(np.float64)
        x_out = (pix % nx).astype(np.float64)
        x_in = out_transform[0][0] * x_out + out_transform[0][1] * y_out + out_origin[0]
        y_in = out_transform[1][0] * x_out + out_transform[1][1] * y_out + out_origin[1]

        xi = np.floor(x_in).astype(np.int32)
        yi = np.floor(y_in).astype(np.int32)
        xo, yo, T_, U_, S_ = InterpMatrix(Rsearch, samp, x_in - xi, y_in - yi,
                                          Cov, epsilon=epsilon, stest=stest)
        bb = max(-xo.min(), xo.max() - 1, -yo.min(), yo.max() - 1)
        if 2 * bb >= min(nx_in, ny_in):
            break
        Umax = max(Umax, float(U_.max()))
        Smax = max(Smax, float(S_.max()))

        sub_mask = (xi < bb) | (xi + 1 + bb >= nx_in) | (yi < bb) | (yi + 1 + bb >= ny_in)
        xi = np.where(sub_mask, bb, xi)
        yi = np.where(sub_mask, bb, yi)

        sl = slice(istart, istart + ngroup)
        out_array[:, sl], out_mask[sl] = gather_taps(
            image, mask, yi.astype(np.int64) * nx_in + xi,
            yo.astype(np.int64) * nx_in + xo, T_, sub_mask)

    out_array[:, out_mask] = 0.0
    out_array = out_array.cpu().numpy()
    out_mask = out_mask.cpu().numpy()
    out_array = out_array.reshape((nlayer, ny, nx)) if is3D else out_array.reshape((ny, nx))
    return out_array, out_mask.reshape(ny, nx), Umax, Smax


def gather_taps(image, mask, base, offsets, T, sub_mask):
    """
    The tap loop of one block of output pixels on the mosaic's device:
    image (nlayer, npix) and mask (npix,) flattened, base (ngroup,) the flat
    index of each output pixel's cell, offsets (NN,) the taps' flat offsets,
    T (ngroup, NN) float64 weights, sub_mask (ngroup,) the pixels whose
    search box leaves the mosaic.  Returns (values (nlayer, ngroup) in the
    image's dtype, mask (ngroup,)): for k in order, the value plus T[:, k]
    times the tap, computed in float64 and rounded to the image's dtype, as
    NumPy's ``out += T_[:, k] * tap`` rounds.
    """
    dev = image.device
    base = torch.as_tensor(base, device=dev)
    T = torch.as_tensor(T, dtype=torch.float64, device=dev)
    out_mask = torch.as_tensor(sub_mask, device=dev)
    acc = torch.zeros((image.shape[0], base.shape[0]), dtype=image.dtype, device=dev)
    for k, off in enumerate(offsets.tolist()):
        idx = base + off
        out_mask |= mask[idx]
        prod = T[:, k] * image[:, idx].to(torch.float64)
        acc = (acc.to(torch.float64) + prod).to(image.dtype)
    return acc, out_mask
