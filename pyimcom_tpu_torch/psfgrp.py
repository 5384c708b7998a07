"""
PSF groups and overlap stacks on PyTorch.

Counterpart of pyimcom_tpu/psfgrp.py.  A PSF group holds the PSFs of all
input images of a 2x2 group of postage stamps, resampled onto the common
output-frame grid (the WCS rotation lives in the sampling positions), and
their zero-padded float64 rFFTs.  An overlap stack holds the
cross-correlation of every PSF pair of two groups, padded for
interpolation.  Everything stays on the block's device; the resampling goes
through the dense interpolation entry, so on the card it runs kernel K1.

Shapes: nsamp = npixpsf*oversamp - 1 samples per axis, FFT grid
nfft = 2*npixpsf*oversamp, overlap window novl = nsamp.
"""

from __future__ import annotations

import numpy as np
import torch

from pyimcom_tpu.config import Settings as Stn

from .device import DTYPE
from .ops.fourier import (apply_amp_penalty, overlap_from_rft, pad_and_rfft2,
                          zero_lag_from_rft)
from .ops.interp import check_kern, grid_interp, interp2d_dense

INTERP_PAD = 6  # guard pixels for the 10x10 interpolation kernel

# query-count buckets of the sweep and the rectangle batch the JAX package
# sized for each; the port launches all rows of a bucket at once, and the
# batch sizes remain the main path's kernel shapes (R x Nq = 128 x 1024,
# 64 x 4096, 32 x 16384)
_DENSE_BUCKETS = (1024, 4096, 16384)
_DENSE_RBATCH_BY_BUCKET = {1024: 128, 4096: 64, 16384: 32}


class PSFGeometry:
    """Static geometry of PSF sampling and overlap arrays for one run."""

    def __init__(self, npixpsf: int = 48, oversamp: int = 8,
                 dtheta: float = 0.025 / 3600, psfsplit: bool = False,
                 psfinterp: str = "D5512"):
        check_kern(psfinterp)
        self.psfinterp = psfinterp
        self.npixpsf = npixpsf
        self.oversamp = oversamp
        self.nsamp = npixpsf * oversamp - 1
        self.nc_samp = self.nsamp // 2
        self.nfft = npixpsf * oversamp * 2
        # sample spacing in output pixels
        self.dscale = (Stn.pixscale_native / Stn.arcsec) / oversamp / (dtheta * 3600)
        self.psfsplit = psfsplit
        # overlap window: doubled when PSF splitting is on (psfutil.py:1088)
        self.novl = 2 * self.nsamp + 1 if psfsplit else self.nsamp
        self.nc_ovl = self.novl // 2

        # unrotated sampling offsets (in samples), center 0
        c = (self.nsamp - 1) / 2.0
        ax = np.arange(self.nsamp, dtype=np.float64) - c
        self.yo = ax  # 1D; the 2D grid is the outer product
        self.xo = ax


class PSFGroup:
    """
    A group of PSFs sampled on the common overlap grid, with their rFFTs.

    psf_arr : (n_psf, nsamp, nsamp) sampled PSFs (tensor or array); they
        and their spectra live on `device`.
    idx_blk2grp / idx_grp2blk : maps between block-level input-image indices
        and the group's PSF slots (input groups only).
    """

    def __init__(self, geom: PSFGeometry, psf_arr, *, device,
                 idx_blk2grp=None, idx_grp2blk=None, psf_circ=False,
                 psf_norm=False, amp_penalty=(0.0, 0.0)):
        self.geom = geom
        self.n_psf = psf_arr.shape[0]
        self.idx_blk2grp = idx_blk2grp
        self.idx_grp2blk = idx_grp2blk

        psf = torch.as_tensor(psf_arr, dtype=DTYPE, device=device)
        if psf_circ:
            yy, xx = np.meshgrid(geom.yo, geom.xo, indexing="ij")
            circ = np.hypot(yy, xx) < geom.nc_samp + 0.5
            psf = psf * torch.as_tensor(circ, dtype=DTYPE, device=device)
        if psf_norm:
            psf = psf / psf.sum(dim=(-2, -1), keepdim=True)
        rft = pad_and_rfft2(psf, geom.nfft)
        if amp_penalty and amp_penalty[0] != 0.0 and amp_penalty[1] != 0.0:
            rft = apply_amp_penalty(rft, geom.nfft, amp_penalty[0],
                                    amp_penalty[1] * geom.oversamp)
        self.psf_rft = rft  # (n_psf, nfft, nfft//2+1) complex128

    def clear(self):
        self.psf_rft = None


def sample_psf_rotated_batch(geom: PSFGeometry, psfs, mapfns,
                             compute_point_pix, *, device) -> torch.Tensor:
    """
    Resample every PSF of a group onto the output-frame grid in one dense
    interpolation (K1 on the card).  The sampling positions are the
    unrotated grid mapped through each exposure's output->input WCS chain,
    so each sampled PSF is in output-frame orientation (reference
    PSFGrp._sample_psf, psfutil.py:709-795).

    psfs : list of (ny, nx) oversampled PSF arrays of one shape, centred at
        ((ny-1)/2, (nx-1)/2).
    mapfns : one outpix2world2inpix callable per PSF.
    Returns (n_psf, nsamp, nsamp) on `device`.
    """
    n_psf = len(psfs)
    ny, nx = psfs[0].shape[-2:]
    xctr = (nx - 1) / 2.0
    yctr = (ny - 1) / 2.0
    yy, xx = np.meshgrid(geom.yo, geom.xo, indexing="ij")
    xyo = np.stack([xx.ravel(), yy.ravel()], axis=-1) * geom.dscale

    qx = np.zeros((n_psf, xyo.shape[0]))
    qy = np.zeros_like(qx)
    stack = np.zeros((n_psf, ny + 2 * INTERP_PAD, nx + 2 * INTERP_PAD))
    for g, (psf, mapfn) in enumerate(zip(psfs, mapfns)):
        inpix = mapfn(xyo + np.asarray(compute_point_pix)[None, :])
        inpix = inpix - mapfn(np.asarray([compute_point_pix]))
        qx[g] = inpix[:, 0] * geom.oversamp + xctr + INTERP_PAD
        qy[g] = inpix[:, 1] * geom.oversamp + yctr + INTERP_PAD
        stack[g] = np.pad(psf, INTERP_PAD)

    def put(a):
        return torch.as_tensor(a, dtype=DTYPE, device=device)

    out = interp2d_dense(put(stack), put(qx), put(qy), geom.psfinterp)
    return out.reshape(n_psf, geom.nsamp, geom.nsamp)


def sample_psf_unrotated(geom: PSFGeometry, psfs: np.ndarray, *,
                         device) -> torch.Tensor:
    """Sample output PSFs on the unrotated grid (reference
    psfutil.py:784-795): (n_psf, ny, nx) -> (n_psf, nsamp, nsamp)."""
    ny, nx = psfs.shape[-2:]
    x = torch.as_tensor((geom.xo + (nx - 1) / 2.0 + INTERP_PAD)[None, :],
                        dtype=DTYPE, device=device)
    y = torch.as_tensor((geom.yo + (ny - 1) / 2.0 + INTERP_PAD)[None, :],
                        dtype=DTYPE, device=device)
    out = [grid_interp(torch.as_tensor(np.pad(p, INTERP_PAD), dtype=DTYPE,
                                       device=device), x, y, geom.psfinterp)[0]
           for p in psfs]
    return torch.stack(out)


def build_overlap_stack(geom: PSFGeometry, grp1: PSFGroup,
                        grp2: PSFGroup | None) -> torch.Tensor:
    """
    Overlap (cross-correlation) images for every PSF pair of two groups,
    padded for interpolation: (n1*n2, novl+2p, novl+2p), pair (i, j) at
    index i*n2 + j.  grp2=None means the self-overlap of grp1.
    """
    g2 = grp2 if grp2 is not None else grp1
    ovl = overlap_from_rft(grp1.psf_rft[:, None], g2.psf_rft[None, :],
                           geom.novl, geom.nfft)      # (n1, n2, novl, novl)
    n1, n2 = ovl.shape[:2]
    p = INTERP_PAD
    return torch.nn.functional.pad(ovl.reshape(n1 * n2, geom.novl, geom.novl),
                                   (p, p, p, p))


def outpsf_C_values(geom: PSFGeometry, outgrp: PSFGroup) -> np.ndarray:
    """Target normalizations C: zero-lag self-overlap per output PSF."""
    return zero_lag_from_rft(outgrp.psf_rft, geom.nfft).cpu().numpy()


def _image_runs(img_idx):
    """Contiguous runs of equal image index: list of (im, start, end)."""
    if len(img_idx) == 0:
        return []
    change = np.nonzero(np.diff(img_idx))[0] + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [len(img_idx)]])
    return [(int(img_idx[s]), int(s), int(e)) for s, e in zip(starts, ends)]
