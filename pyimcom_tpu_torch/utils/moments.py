"""
Adaptive Gaussian moments (HSM-style) of image stamps.

The port's copy of ``pyimcom_tpu/utils/moments.py``, so that the port imports
nothing of the JAX package; keep the two in step.

Replacement for the GalSim FindAdaptiveMom calls the reference makes in its
analysis/diagnostics (reference analysis.py:852-1127, psfutil.py:498-517);
GalSim is not available in this environment.  The algorithm is the standard
adaptive-moments iteration (Hirata & Seljak 2003; Bernstein & Jarvis 2002):
measure Gaussian-weighted centroid and second moments, replace the weight
with the measured Gaussian, iterate to the fixed point where the weight
matches the object.  At convergence the returned covariance is twice the
weighted second moment of the image for a Gaussian profile, which is
corrected for internally, matching HSM conventions:

* ``moments_sigma`` = |det M|^(1/4) of the adaptive covariance (pixels)
* ``observed_e1/e2`` = distortion-style ellipticities
* ``moments_amp`` = amplitude of the best-fit elliptical Gaussian
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class MomentResult:
    amp: float
    x0: float
    y0: float
    Mxx: float
    Mxy: float
    Myy: float
    n_iter: int
    converged: bool

    @property
    def moments_sigma(self) -> float:
        det = self.Mxx * self.Myy - self.Mxy ** 2
        return float(det) ** 0.25 if det > 0 else np.nan

    @property
    def moments_amp(self) -> float:
        return self.amp

    @property
    def observed_e1(self) -> float:
        return (self.Mxx - self.Myy) / (self.Mxx + self.Myy)

    @property
    def observed_e2(self) -> float:
        return 2.0 * self.Mxy / (self.Mxx + self.Myy)

    @property
    def centroid(self):
        return (self.x0, self.y0)


def find_adaptive_moments(image: np.ndarray, guess_sigma: float = 2.0,
                          max_iter: int = 100, tol: float = 1e-8) -> MomentResult:
    """
    Adaptive Gaussian moments of a 2D stamp (origin at pixel (0, 0)).

    Iterates the weighted-moment fixed point; for a Gaussian image of
    covariance C the converged adaptive covariance equals C.
    """
    image = np.asarray(image, dtype=np.float64)
    ny, nx = image.shape
    yy, xx = np.mgrid[0:ny, 0:nx].astype(np.float64)

    tot = image.sum()
    if tot <= 0:
        return MomentResult(0.0, np.nan, np.nan, np.nan, np.nan, np.nan, 0, False)
    x0 = float((image * xx).sum() / tot)
    y0 = float((image * yy).sum() / tot)
    Mxx = Myy = guess_sigma ** 2
    Mxy = 0.0

    converged = False
    it = 0
    for it in range(1, max_iter + 1):
        det = Mxx * Myy - Mxy ** 2
        if det <= 0:
            break
        inv_xx = Myy / det
        inv_yy = Mxx / det
        inv_xy = -Mxy / det
        dx = xx - x0
        dy = yy - y0
        arg = inv_xx * dx * dx + 2 * inv_xy * dx * dy + inv_yy * dy * dy
        w = np.exp(-0.5 * arg)
        wim = w * image
        s = wim.sum()
        if s <= 0:
            break
        nx0 = float((wim * xx).sum() / s)
        ny0 = float((wim * yy).sum() / s)
        dx = xx - nx0
        dy = yy - ny0
        # weighted second moments; x2 corrects the weight/object convolution
        # (weight == object at the fixed point halves the measured moments)
        nMxx = 2.0 * float((wim * dx * dx).sum() / s)
        nMxy = 2.0 * float((wim * dx * dy).sum() / s)
        nMyy = 2.0 * float((wim * dy * dy).sum() / s)
        shift = max(abs(nMxx - Mxx), abs(nMyy - Myy), abs(nMxy - Mxy),
                    abs(nx0 - x0), abs(ny0 - y0))
        x0, y0, Mxx, Mxy, Myy = nx0, ny0, nMxx, nMxy, nMyy
        if shift < tol:
            converged = True
            break

    det = Mxx * Myy - Mxy ** 2
    amp = 0.0
    if det > 0:
        # best-fit Gaussian amplitude: flux of weighted image relative to the
        # weight normalization at the fixed point
        inv_xx = Myy / det
        inv_yy = Mxx / det
        inv_xy = -Mxy / det
        dx = xx - x0
        dy = yy - y0
        arg = inv_xx * dx * dx + 2 * inv_xy * dx * dy + inv_yy * dy * dy
        w = np.exp(-0.5 * arg)
        amp = 2.0 * float((w * image).sum()) / float(w.sum())

    return MomentResult(amp, x0, y0, Mxx, Mxy, Myy, it, converged)


def fourth_moments(image: np.ndarray, mom: MomentResult) -> dict:
    """
    Gaussian-weighted standardized fourth moments about the adaptive
    centroid (used by the star-catalog diagnostics; reference
    analysis.py:852-1127 'StarsAnal' column schema).
    """
    image = np.asarray(image, dtype=np.float64)
    ny, nx = image.shape
    yy, xx = np.mgrid[0:ny, 0:nx].astype(np.float64)
    det = mom.Mxx * mom.Myy - mom.Mxy ** 2
    inv_xx = mom.Myy / det
    inv_yy = mom.Mxx / det
    inv_xy = -mom.Mxy / det
    dx = xx - mom.x0
    dy = yy - mom.y0
    arg = inv_xx * dx * dx + 2 * inv_xy * dx * dy + inv_yy * dy * dy
    w = np.exp(-0.5 * arg)
    wim = w * image
    s = wim.sum()
    # standardized coordinates
    sig = det ** 0.25
    u = dx / sig
    v = dy / sig
    out = {}
    for (p, q) in [(4, 0), (3, 1), (2, 2), (1, 3), (0, 4)]:
        out[f"M{p}{q}"] = float((wim * u ** p * v ** q).sum() / s)
    return out
