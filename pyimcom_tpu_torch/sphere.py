"""
Spherical geometry helpers and a minimal HEALPix (RING scheme) implementation.

The port's copy of ``pyimcom_tpu/sphere.py``, so that the port imports
nothing of the JAX package; keep the two in step.

The injection subsystem lays simulated stars/galaxies on HEALPix grids
(reference layer.py:689-790 uses healpy); healpy is not available in this
environment, so the framework carries its own vectorized RING-scheme
ang2pix / pix2ang (Gorski et al. 2005 Eqs. 2-12).
"""

from __future__ import annotations

import numpy as np


def nside2npix(nside: int) -> int:
    return 12 * nside * nside


def pix2ang_ring(nside: int, ipix):
    """
    RING-scheme pixel index -> (theta, phi) of pixel centers in radians.
    theta is the colatitude (0 at the north pole).
    """
    ipix = np.asarray(ipix, dtype=np.int64)
    npix = nside2npix(nside)
    if np.any((ipix < 0) | (ipix >= npix)):
        raise ValueError("pixel index out of range")
    ncap = 2 * nside * (nside - 1)
    theta = np.empty(ipix.shape, dtype=np.float64)
    phi = np.empty(ipix.shape, dtype=np.float64)

    # north polar cap
    m = ipix < ncap
    if np.any(m):
        p = ipix[m]
        ph = (p + 1) / 2.0
        i = np.floor(np.sqrt(ph - np.sqrt(np.floor(ph)))).astype(np.int64) + 1
        j = p + 1 - 2 * i * (i - 1)
        theta[m] = np.arccos(1.0 - i * i / (3.0 * nside * nside))
        phi[m] = (j - 0.5) * np.pi / (2.0 * i)

    # equatorial belt
    m = (ipix >= ncap) & (ipix < npix - ncap)
    if np.any(m):
        p = ipix[m] - ncap
        i = p // (4 * nside) + nside
        j = p % (4 * nside) + 1
        fodd = 0.5 * (1 + (i + nside) % 2)  # alternating ring phase
        theta[m] = np.arccos(4.0 / 3.0 - 2.0 * i / (3.0 * nside))
        phi[m] = (j - fodd) * np.pi / (2.0 * nside)

    # south polar cap
    m = ipix >= npix - ncap
    if np.any(m):
        p = npix - 1 - ipix[m]
        ph = (p + 1) / 2.0
        i = np.floor(np.sqrt(ph - np.sqrt(np.floor(ph)))).astype(np.int64) + 1
        j = p + 1 - 2 * i * (i - 1)
        theta[m] = np.arccos(-1.0 + i * i / (3.0 * nside * nside))
        phi[m] = 2.0 * np.pi - (j - 0.5) * np.pi / (2.0 * i)

    return theta, phi


def ang2pix_ring(nside: int, theta, phi):
    """RING-scheme (theta, phi) in radians -> pixel index."""
    theta = np.asarray(theta, dtype=np.float64)
    phi = np.asarray(phi, dtype=np.float64)
    z = np.cos(theta)
    za = np.abs(z)
    tt = np.mod(phi, 2.0 * np.pi) / (0.5 * np.pi)  # in [0, 4)
    pix = np.empty(np.broadcast(theta, phi).shape, dtype=np.int64)
    ncap = 2 * nside * (nside - 1)
    npix = nside2npix(nside)

    eq = za <= 2.0 / 3.0
    if np.any(eq):
        t1 = nside * (0.5 + tt[eq])
        t2 = nside * (z[eq] * 0.75)
        jp = np.floor(t1 - t2).astype(np.int64)  # ascending edge index
        jm = np.floor(t1 + t2).astype(np.int64)  # descending edge index
        ir = nside + 1 + jp - jm                 # ring counted from z=2/3
        kshift = 1 - (ir & 1)
        ip = (jp + jm - nside + kshift + 1) // 2
        ip = np.mod(ip, 4 * nside)
        pix[eq] = ncap + (ir - 1) * 4 * nside + ip

    po = ~eq
    if np.any(po):
        tp = tt[po] - np.floor(tt[po])
        tmp = nside * np.sqrt(3.0 * (1.0 - za[po]))
        jp = np.floor(tp * tmp).astype(np.int64)
        jm = np.floor((1.0 - tp) * tmp).astype(np.int64)
        ir = jp + jm + 1
        ip = np.floor(tt[po] * ir).astype(np.int64)
        ip = np.mod(ip, 4 * ir)
        north = z[po] > 0
        pp = np.where(north, 2 * ir * (ir - 1) + ip, npix - 2 * ir * (ir + 1) + ip)
        pix[po] = pp

    return pix


def healpix_patch(res: int, ra: float, dec: float, radius: float) -> dict:
    """
    HEALPix pixels (RING, nside=2**res) within `radius` of (ra, dec), all in
    radians.  Matches the reference injection grid contract
    (layer.py:689-740): scan the contiguous RING index range covering the
    declination band, then cut to the circular patch.
    """
    nside = 2 ** res
    radext = radius + 3.0 / nside
    dmin = max(dec - radext, -np.pi / 2.0)
    dmax = min(dec + radext, np.pi / 2.0)
    pmin = int(ang2pix_ring(nside, np.pi / 2.0 - dmax, ra))
    pmax = int(ang2pix_ring(nside, np.pi / 2.0 - dmin, ra))
    pvec = np.arange(pmin, pmax + 1, dtype=np.int64)
    theta, phi = pix2ang_ring(nside, pvec)
    thetac = np.pi / 2.0 - theta

    mu = np.sin(thetac) * np.sin(dec) + np.cos(thetac) * np.cos(dec) * np.cos(ra - phi)
    good = mu >= np.cos(radius)
    return {
        "res": res,
        "nside": nside,
        "npix": int(np.count_nonzero(good)),
        "ipix": pvec[good],
        "rapix": phi[good],
        "decpix": thetac[good],
    }
