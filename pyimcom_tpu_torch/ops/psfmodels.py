"""
Analytic target-PSF models and PSF preparation utilities (host-side setup).

The port's copy of ``pyimcom_tpu/ops/psfmodels.py``, so that the port imports
nothing of the JAX package; keep the two in step.

Counterpart of the reference ``OutPSF`` model zoo (src/pyimcom/psfutil.py:96-316)
and ``InImage.smooth_and_pad`` / ``LPolyArr`` (src/pyimcom/coadd.py:432-510).
These run once per block at setup time, so they are plain numpy + scipy; the
hot per-stamp compute stays on device.

All PSFs are normalized to *sum* to unity when analytically extended (an
Airy stamp enclosing 90% of the energy sums to 0.9).
"""

from __future__ import annotations

import numpy as np
from scipy.special import eval_legendre, jv


def _centered_grid(n: int):
    """(y, x) offsets from the stamp center, center at (n-1)/2."""
    c = (n - 1) / 2.0
    ax = np.arange(n, dtype=np.float64) - c
    return ax[:, None], ax[None, :]


def _fft_freqs(n: int):
    """Signed frequencies in cycles/pixel for an n-point DFT."""
    u = np.arange(n, dtype=np.float64) / n
    return np.where(u > 0.5, u - 1.0, u)


def _convolve_tophat_gauss(img: np.ndarray, tophat: float, sigma: float) -> np.ndarray:
    """Fourier-space convolution with a square tophat and a Gaussian."""
    n = img.shape[-1]
    uy = _fft_freqs(img.shape[-2])[:, None]
    ux = _fft_freqs(n)[None, : n // 2 + 1]
    ft = np.fft.rfft2(img)
    ft *= (np.sinc(ux * tophat) * np.sinc(uy * tophat)
           * np.exp(-2.0 * np.pi ** 2 * sigma ** 2 * (ux ** 2 + uy ** 2)))
    return np.fft.irfft2(ft, s=img.shape[-2:])


def psf_gaussian(n: int, sigmax: float, sigmay: float) -> np.ndarray:
    """Centered Gaussian spot, integrates to unity."""
    y, x = _centered_grid(n)
    r2 = (x / sigmax) ** 2 + (y / sigmay) ** 2
    return np.exp(-0.5 * r2) / (2.0 * np.pi * sigmax * sigmay)


def _airy_core(r: np.ndarray, obsc: float) -> np.ndarray:
    """Amplitude of an (optionally obscured) Airy pattern; r in units of lambda/D."""
    a = jv(0, np.pi * r) + jv(2, np.pi * r)
    if obsc > 0.0:
        a = a - obsc ** 2 * (jv(0, np.pi * r * obsc) + jv(2, np.pi * r * obsc))
    return a


def psf_simple_airy(n: int, ldp: float, obsc: float = 0.0,
                    tophat_conv: float = 0.0, sigma: float = 0.0) -> np.ndarray:
    """
    Airy spot with lambda/D = `ldp` pixels, optionally linearly obscured by
    `obsc`, convolved with a square tophat (full width `tophat_conv`) and a
    Gaussian (`sigma`).  Centered on ((n-1)/2, (n-1)/2).
    """
    kp = 1 + int(np.ceil(tophat_conv + 6 * sigma))
    npad = n + 2 * kp
    y, x = _centered_grid(npad)
    r = np.hypot(x, y) / ldp
    intensity = _airy_core(r, obsc) ** 2 * np.pi / (4.0 * ldp ** 2 * (1 - obsc ** 2))
    out = _convolve_tophat_gauss(intensity, tophat_conv, sigma)
    return out[kp:-kp, kp:-kp]


def psf_cplx_airy(n: int, ldp: float, tophat_conv: float = 0.0,
                  sigma: float = 0.0, features: int = 0) -> np.ndarray:
    """
    Messier Airy spot with six diffraction-spike sinc streaks and optional
    extra features (bit flags in `features`), band-limited; used to emulate a
    realistic instrument PSF in tests (cf. reference psfutil.py:225-316).
    """
    kp = 1 + int(np.ceil(tophat_conv + 6 * sigma))
    npad = n + 2 * kp
    y, x = _centered_grid(npad)
    r = np.hypot(x, y) / ldp
    phi = np.arctan2(y, x)

    L1, L2 = 0.8, 0.01
    f = L1 * L2 * 4.0 / np.pi
    amp = jv(0, np.pi * r) + jv(2, np.pi * r)
    for t in range(6):
        ang = phi + t * np.pi / 6.0
        amp = amp - f * np.sinc(L1 * r * np.cos(ang)) * np.sinc(L2 * r * np.sin(ang))
    intensity = amp ** 2 * np.pi / (4.0 * ldp ** 2 * (1 - 6 * f))
    del amp

    if features & 1:
        rp = np.hypot(x - 1 * ldp, y + 2 * ldp) / (2.0 * ldp)
        blob = (jv(0, np.pi * rp) + jv(2, np.pi * rp)) ** 2 * np.pi / (4.0 * (2.0 * ldp) ** 2)
        intensity = 0.8 * intensity + 0.2 * blob
    if features & 2:
        shifted = np.copy(intensity)
        intensity *= 0.85
        intensity[:-8, :] += 0.15 * shifted[8:, :]
    if features & 4:
        shifted = np.copy(intensity)
        intensity *= 0.8
        intensity[:-4, :-4] += 0.1 * shifted[4:, 4:]
        intensity[4:, :-4] += 0.1 * shifted[:-4, 4:]

    out = _convolve_tophat_gauss(intensity, tophat_conv, sigma)
    return out[kp:-kp, kp:-kp]


def smooth_and_pad(arr: np.ndarray, tophatwidth: float = 0.0,
                   gaussiansigma: float = 0.0) -> np.ndarray:
    """
    Pad a PSF stamp and smear it with a tophat (the native pixel response)
    and a Gaussian.  Pad size is a multiple of 4 covering the kernel support
    (cf. reference coadd.py:432-474).

    Returns an array of shape (ny + 2*npad, nx + 2*npad).
    """
    npad = int(np.ceil(tophatwidth + 6 * gaussiansigma + 1))
    npad += (4 - npad) % 4
    ny, nx = arr.shape
    out = np.zeros((ny + 2 * npad, nx + 2 * npad))
    out[npad:-npad, npad:-npad] = arr
    uy = _fft_freqs(out.shape[0])[:, None]
    ux = _fft_freqs(out.shape[1])[None, :]
    ft = np.fft.fft2(out)
    ft *= (np.sinc(ux * tophatwidth) * np.sinc(uy * tophatwidth)
           * np.exp(-2.0 * np.pi ** 2 * gaussiansigma ** 2 * (ux ** 2 + uy ** 2)))
    return np.real(np.fft.ifft2(ft))


def smooth_and_pad_batch(arr: np.ndarray, tophatwidth: float = 0.0,
                         gaussiansigma: float = 0.0) -> np.ndarray:
    """Batched :func:`smooth_and_pad` over a leading stack axis."""
    npad = int(np.ceil(tophatwidth + 6 * gaussiansigma + 1))
    npad += (4 - npad) % 4
    ns, ny, nx = arr.shape
    out = np.zeros((ns, ny + 2 * npad, nx + 2 * npad))
    out[:, npad:-npad, npad:-npad] = arr
    uy = _fft_freqs(out.shape[1])[:, None]
    ux = _fft_freqs(out.shape[2])[None, : out.shape[2] // 2 + 1]
    ft = np.fft.rfft2(out)
    ft *= (np.sinc(ux * tophatwidth) * np.sinc(uy[: out.shape[1]] * tophatwidth)
           * np.exp(-2.0 * np.pi ** 2 * gaussiansigma ** 2 * (ux ** 2 + uy ** 2)))
    return np.fft.irfft2(ft, s=out.shape[1:])


def legendre_poly_array(porder: int, u: float, v: float) -> np.ndarray:
    """
    Products P_m(u) P_n(v) for m, n in 0..porder, flattened with x-order
    fastest (cf. reference coadd.py:476-510).  Used to evaluate spatially
    varying PSF Legendre cubes at a chip position.
    """
    m = np.arange(porder + 1)
    ua = eval_legendre(m, u)
    va = eval_legendre(m, v)
    return np.outer(va, ua).ravel()


def eval_psf_cube_batch(cube: np.ndarray, x: np.ndarray, y: np.ndarray,
                        nside: int = 4088) -> np.ndarray:
    """Evaluate a Legendre PSF cube at many chip positions: (S, ny, nx)."""
    porder = int(np.round(np.sqrt(cube.shape[0]))) - 1
    half = (nside - 1) / 2.0
    u = (np.asarray(x) - half) / (half + 0.5)
    v = (np.asarray(y) - half) / (half + 0.5)
    morder = np.arange(porder + 1)
    ua = eval_legendre(morder[None, :], u[:, None])   # (S, p+1)
    va = eval_legendre(morder[None, :], v[:, None])
    lp = (va[:, :, None] * ua[:, None, :]).reshape(len(u), -1)  # (S, (p+1)^2)
    return np.tensordot(lp, cube, axes=(1, 0))


def eval_psf_cube(cube: np.ndarray, x: float, y: float, nside: int = 4088) -> np.ndarray:
    """
    Evaluate a Legendre-coefficient PSF cube at chip position (x, y).

    Parameters
    ----------
    cube : ((porder+1)**2, ny, nx) coefficient cube.
    x, y : chip pixel position (0-indexed).
    nside : chip side length for the [-1, 1] rescaling.
    """
    porder = int(np.round(np.sqrt(cube.shape[0]))) - 1
    half = (nside - 1) / 2.0
    lp = legendre_poly_array(porder, (x - half) / (half + 0.5), (y - half) / (half + 0.5))
    return np.tensordot(lp, cube, axes=(0, 0))
