"""
SCA-to-SCA geometry helpers: spherical footprints, pixel mappings, and
overlap matrices (counterpart of reference src/pyimcom/utils/compareutils.py).

The port's copy of ``pyimcom_tpu/utils/compareutils.py``, so that the port
imports nothing of the JAX package; keep the two in step.
"""

from __future__ import annotations

import numpy as np

from ..config import Settings as Stn

DEG = np.pi / 180.0


def getfootprint(mywcs, pad, nside=None):
    """
    Bounding cap of an SCA: [x, y, z, p] with (x, y, z) the Cartesian center
    direction and p = 1 - cos(theta_max) over the (padded) corners.
    """
    nside = nside or Stn.sca_nside
    hw = nside / 2.0 + pad
    xi = np.array([0, -hw, -hw, hw, hw]) + (nside - 1.0) / 2.0
    yi = np.array([0, -hw, hw, -hw, hw]) + (nside - 1.0) / 2.0
    ra, dec = mywcs.pix2world(xi, yi)
    M = np.stack((np.cos(dec * DEG) * np.cos(ra * DEG),
                  np.cos(dec * DEG) * np.sin(ra * DEG),
                  np.sin(dec * DEG)), axis=1)
    p = np.sum((M - M[0]) ** 2, axis=1) / 2.0
    return np.array([M[0, 0], M[0, 1], M[0, 2], np.max(p)])


def map_sca2sca(target_wcs, ref_wcs, pad=0, dtype=np.float64, subsamp=1,
                nside=None):
    """
    Pixel mapping target -> reference: for every (padded, subsampled) pixel
    of the target SCA, the (x, y) in the reference SCA and an in-bounds mask.
    """
    nside = nside or Stn.sca_nside
    s = np.linspace(-pad, nside - 1 + pad, nside + 2 * pad)
    if subsamp > 1:
        s = s[subsamp // 2::subsamp]
    xi, yi = np.meshgrid(s, s)
    ra, dec = target_wcs.pix2world(xi.ravel(), yi.ravel())
    xf, yf = ref_wcs.world2pix(ra, dec)
    xf = xf.reshape(xi.shape)
    yf = yf.reshape(xi.shape)
    is_in_ref = ((xf + 0.5 + pad) * (nside - 0.5 - xf + pad) > 0) \
        & ((yf + 0.5 + pad) * (nside - 0.5 - yf + pad) >= 0)
    return xf.astype(dtype, copy=False), yf.astype(dtype, copy=False), is_in_ref


def get_overlap_matrix(list_of_wcs, pad=0, verbose=False, subsamp=8, nside=None):
    """
    (N, N) fractional-overlap matrix of a list of WCSs, with a cheap
    bounding-cap pre-cut before the pixel-level test.
    """
    nside = nside or Stn.sca_nside
    N = len(list_of_wcs)
    caps = np.array([getfootprint(w, pad, nside=nside) for w in list_of_wcs])
    out = np.zeros((N, N))
    for i in range(N):
        out[i, i] = 1.0
        for j in range(N):
            if i == j:
                continue
            # cap distance test: overlap possible iff
            # 1 - dot(ci, cj) <= (sqrt(pi) + sqrt(pj))^2 / ... use chord bound
            dd = np.sum((caps[i, :3] - caps[j, :3]) ** 2) / 2.0
            if np.sqrt(dd) > np.sqrt(caps[i, 3]) + np.sqrt(caps[j, 3]):
                continue
            _, _, in_ref = map_sca2sca(list_of_wcs[i], list_of_wcs[j], pad=pad,
                                       subsamp=subsamp, nside=nside)
            out[i, j] = np.mean(in_ref)
            if verbose and out[i, j] > 0:
                print(f"overlap[{i},{j}] = {out[i, j]:.3f}")
    return out


def str2dirstem(stem):
    """Split a path stem into (directory, file stem)."""
    idx = stem.rfind("/")
    if idx < 0:
        return "", stem
    return stem[:idx + 1], stem[idx + 1:]
