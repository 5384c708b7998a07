"""
Metadetection mosaics: load a 3x3 block neighborhood, mask on quality maps,
and generate sheared / reconvolved resampled images.

Counterpart of pyimcom_tpu/meta/distortimage.py (reference
src/pyimcom/meta/distortimage.py: MetaMosaic, shearimage, origimage).  The
mosaic's reading, masks, WCS and the shear decomposition are host copies;
the resampling runs ginterp.MultiInterp's tap gather on the mosaic's device
(``MetaMosaic(..., device="cuda")``, the default).  Only Gaussian target
PSFs support shearing (the deconvolution is analytic for Gaussians).
"""

from __future__ import annotations

import numpy as np

from ..analysis import decode_quality_map
from ..compress import ReadFile
from ..config import Config, Settings
from ..device import resolve_device
from ..fitsio import HDUList, Header, ImageHDU, fits_write
from ..wcsutil import WCS
from . import ginterp

DEG = np.pi / 180.0


class MetaMosaic:
    """
    A 3x3-block sub-mosaic centered on one block, with quality masks.

    Parameters
    ----------
    fname : central block file (<stem>_XX_YY.fits).
    extpix : extend this many pixels beyond the central block (None = full
        3x3 region).
    device : where shearimage resamples: "cuda" (default) or "cpu"; asking
        for CUDA without a GPU raises.
    """

    def __init__(self, fname, bbox=None, extpix=None, verbose=False, device="cuda"):
        self.device = resolve_device(device)
        fname = str(fname)
        f = ReadFile(fname)
        self.cfg = Config(fname, inmode="block")
        self.nlayer = f[0].data.shape[-3]
        self.im_dtype = f[0].data.dtype

        self.stem = fname[:-11]
        tail = fname[-11:]
        self.ix = int(tail[1:3])
        self.iy = int(tail[4:6])

        nblk = self.cfg.nblock
        xmin_, xmax_, ymin_, ymax_ = (0, nblk, 0, nblk) if bbox is None else bbox

        n = self.cfg.n1 * self.cfg.n2  # interior block size in pixels
        self.trunc = max(n - extpix, 0) if extpix is not None else 0
        self.Nside = 3 * n - 2 * self.trunc

        self.in_image = np.zeros((self.nlayer, self.Nside, self.Nside), dtype=self.im_dtype)
        self.in_fidelity = np.zeros((self.Nside, self.Nside), dtype=np.float32)
        self.in_noise = np.zeros((self.Nside, self.Nside), dtype=np.float32)
        self.in_mask = np.ones((self.Nside, self.Nside), dtype=bool)

        pad = self.cfg.postage_pad * self.cfg.n2

        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                bx, by = self.ix + dx, self.iy + dy
                if not (xmin_ <= bx < xmax_ and ymin_ <= by < ymax_):
                    continue
                bfile = f"{self.stem}_{bx:02d}_{by:02d}.fits"
                try:
                    fb = ReadFile(bfile) if (dx, dy) != (0, 0) else f
                except (FileNotFoundError, ValueError):
                    continue
                img = np.asarray(fb[0].data[0])
                if pad > 0:
                    img = img[:, pad:-pad, pad:-pad]
                # mosaic coordinates of this block's interior
                x0 = (dx + 1) * n - self.trunc
                y0 = (dy + 1) * n - self.trunc
                sx0, sy0 = max(0, -x0), max(0, -y0)
                ex = min(n, self.Nside - x0)
                ey = min(n, self.Nside - y0)
                if ex <= sx0 or ey <= sy0:
                    continue
                tgt = np.s_[y0 + sy0:y0 + ey, x0 + sx0:x0 + ex]
                src = np.s_[sy0:ey, sx0:ex]
                self.in_image[:, tgt[0], tgt[1]] = img[:, src[0], src[1]]
                self.in_mask[tgt] = False
                try:
                    fid = fb["FIDELITY"]
                    m = decode_quality_map(np.asarray(fid.data[0]), str(fid.header["UNIT"]))
                    if pad > 0:
                        m = m[pad:-pad, pad:-pad]
                    # store in dB: -10 log10(U/C)
                    with np.errstate(divide="ignore"):
                        self.in_fidelity[tgt] = np.where(m[src] > 0,
                                                         -10 * np.log10(m[src]), 0.0)
                except KeyError:
                    pass
                try:
                    s = fb["SIGMA"]
                    m = decode_quality_map(np.asarray(s.data[0]), str(s.header["UNIT"]))
                    if pad > 0:
                        m = m[pad:-pad, pad:-pad]
                    self.in_noise[tgt] = m[src]
                except KeyError:
                    pass

        # mosaic WCS: same projection, origin shifted to the 3x3 corner
        ctr_crpix1 = (self.cfg.NsideP + 1) / 2.0 - self.cfg.Nside * (
            self.ix - (nblk - 1) / 2.0)
        # interior of block (ix-1, iy-1) starts at mosaic pixel 0
        crpix1 = ctr_crpix1 - pad + n + self.trunc
        ctr_crpix2 = (self.cfg.NsideP + 1) / 2.0 - self.cfg.Nside * (
            self.iy - (nblk - 1) / 2.0)
        crpix2 = ctr_crpix2 - pad + n + self.trunc
        self.wcs = WCS(ctype=("RA---STG", "DEC--STG"),
                       crval=(self.cfg.ra, self.cfg.dec),
                       crpix=(crpix1 - 1.0, crpix2 - 1.0),
                       cd=np.diag([-self.cfg.dtheta, self.cfg.dtheta]),
                       lonpole=self.cfg.lonpole)

    # ----- masking ---------------------------------------------------------

    def maskpix(self, mask):
        self.in_mask |= mask

    def mask_fidelity_cut(self, fidelity_min: float):
        """Mask pixels below a fidelity threshold in dB (reference :242)."""
        self.in_mask |= self.in_fidelity < fidelity_min

    def mask_noise_cut(self, noise_max: float):
        self.in_mask |= self.in_noise > noise_max

    def mask_caps(self, ras, decs, radii_deg):
        """Mask circular caps around (ra, dec) positions."""
        yy, xx = np.mgrid[0:self.Nside, 0:self.Nside]
        ra, dec = self.wcs.pix2world(xx.ravel().astype(float), yy.ravel().astype(float))
        for r0, d0, rad in zip(np.atleast_1d(ras), np.atleast_1d(decs),
                               np.atleast_1d(radii_deg)):
            mu = (np.sin(dec * DEG) * np.sin(d0 * DEG)
                  + np.cos(dec * DEG) * np.cos(d0 * DEG) * np.cos((ra - r0) * DEG))
            self.in_mask |= (mu > np.cos(rad * DEG)).reshape(self.Nside, self.Nside)

    # ----- resampling ------------------------------------------------------

    def shearimage(self, N, jac=None, psfgrow=1.0, oversamp=1.0,
                   fidelity_min=None, Rsearch=6.0, select_layers=None,
                   verbose=False):
        """
        Deconvolve-shear-reconvolve-resample to an (N, N) image with a new
        STG WCS (reference distortimage.py:393-594).  Gaussian PSFs only.
        """
        if self.cfg.outpsf != "GAUSSIAN":
            raise ValueError("shearimage: only works on GAUSSIAN, received "
                             + self.cfg.outpsf)
        J_orig = np.identity(2) if jac is None else np.asarray(jac, dtype=np.float64)
        J = J_orig / oversamp
        scale = self.cfg.dtheta
        n = self.cfg.n1 * self.cfg.n2
        nblk = self.cfg.nblock

        Q_orig = np.array([nblk / 2 - self.ix - 0.5, nblk / 2 - self.iy - 0.5]) * n
        Q_new = np.linalg.solve(J, Q_orig)
        xref = np.round(Q_new[0] + 1e-7) + 0.5 + N / 2
        yref = np.round(Q_new[1] + 1e-7) + 0.5 + N / 2

        opos = J @ np.array([1 - xref, 1 - yref])
        opos[0] += (nblk / 2 - self.ix + 1) * n - 0.5 - self.trunc
        opos[1] += (nblk / 2 - self.iy + 1) * n - 0.5 - self.trunc

        outwcs = WCS(ctype=("RA---STG", "DEC--STG"),
                     crval=(self.cfg.ra, self.cfg.dec),
                     crpix=(xref - 1.0, yref - 1.0),
                     cd=np.array([[-J[0, 0] * scale, -J[0, 1] * scale],
                                  [J[1, 0] * scale, J[1, 1] * scale]]),
                     lonpole=self.cfg.lonpole)

        inmask = self.in_mask.copy()
        if fidelity_min is not None:
            inmask |= self.in_fidelity < fidelity_min

        sigma = self.cfg.sigmatarget * Settings.pixscale_native * (180.0 / np.pi) / self.cfg.dtheta
        dCov = sigma ** 2 * (psfgrow ** 2 * J_orig @ J_orig.T - np.identity(2))
        C = [dCov[0, 0], dCov[0, 1], dCov[1, 1]]

        ul = np.arange(self.in_image.shape[0]) if select_layers is None \
            else np.asarray(select_layers, dtype=np.int64)
        layerlist = [self.cfg.extrainput[i] for i in ul]

        image, mask, Umax, Smax = ginterp.MultiInterp(
            self.in_image[ul], inmask, (N, N), opos, J, Rsearch,
            sigma * np.sqrt(8 * np.log(2)), C, device=self.device)

        # shear decomposition of the Jacobian
        z = J_orig[0, 0] + J_orig[1, 1] + 1j * (J_orig[1, 0] - J_orig[0, 1])
        cpd, apx = np.abs(z), np.angle(z)
        z = J_orig[0, 0] - J_orig[1, 1] + 1j * (J_orig[1, 0] + J_orig[0, 1])
        cmd, amx = np.abs(z), np.angle(z)
        Eig1, Eig2 = (cpd + cmd) / 2.0, (cpd - cmd) / 2.0
        alpha = (apx + amx) / 2.0
        eta = -np.log(Eig1 / Eig2)
        pars = {
            "STEM": self.stem, "BLOCKX": self.ix, "BLOCKY": self.iy,
            "UMAX": Umax, "SMAX": Smax,
            "JXX": J_orig[0, 0], "JXY": J_orig[0, 1],
            "JYX": J_orig[1, 0], "JYY": J_orig[1, 1],
            "COVXX": C[0], "COVXY": C[1], "COVYY": C[2],
            "SIGMAOUT": self.cfg.sigmatarget * Settings.pixscale_native
            * (180.0 / np.pi) * 3600 * psfgrow,
            "PIXSCALE": self.cfg.dtheta * 3600 / oversamp,
            "OVERSAMP": oversamp,
            "MU": 1.0 / (Eig1 * Eig2),
            "ETA1": eta * np.cos(2 * alpha), "ETA2": eta * np.sin(2 * alpha),
            "JROTATE": apx,
            "G1": np.tanh(eta / 2.0) * np.cos(2 * alpha),
            "G2": np.tanh(eta / 2.0) * np.sin(2 * alpha),
            "CONV": 1.0 - (Eig1 + Eig2) / 2.0,
        }
        return {"image": image, "mask": mask, "wcs": outwcs, "pars": pars,
                "layers": layerlist,
                "psf_fwhm": np.sqrt(8.0 * np.log(2)) * pars["SIGMAOUT"],
                "ref": (xref - 1, yref - 1)}

    def origimage(self, N=None, select_layers=None):
        """Extract the central region without deconvolution/shear."""
        if N is None:
            N = self.Nside
        c0 = (self.Nside - N) // 2
        ul = np.arange(self.in_image.shape[0]) if select_layers is None \
            else np.asarray(select_layers, dtype=np.int64)
        sl = np.s_[c0:c0 + N, c0:c0 + N]
        return {"image": self.in_image[ul][:, sl[0], sl[1]],
                "mask": self.in_mask[sl], "wcs": self.wcs,
                "layers": [self.cfg.extrainput[i] for i in ul]}

    def to_file(self, imdict, fname):
        """Write a shearimage/origimage result to FITS."""
        hdr = Header(imdict["wcs"].to_header())
        for k, v in imdict.get("pars", {}).items():
            if isinstance(v, (int, float, np.integer, np.floating, str)):
                hdr[k] = v if not isinstance(v, np.generic) else v.item()
        hdus = HDUList([ImageHDU(np.asarray(imdict["image"], dtype=np.float32),
                                 header=hdr),
                        ImageHDU(imdict["mask"].astype(np.uint8), name="MASK")])
        fits_write(fname, hdus)


def shearmosaic(fname, N, device="cuda", **kwargs):
    """One-call helper: load a MetaMosaic and produce a sheared image."""
    mm = MetaMosaic(fname, device=device)
    return mm.shearimage(N, **kwargs)
