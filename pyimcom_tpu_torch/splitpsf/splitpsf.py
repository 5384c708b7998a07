"""
PSF short/long-range decomposition: G = G^S + K (*) Gamma + zeta.

The port's copy of ``pyimcom_tpu/splitpsf/splitpsf.py`` (host NumPy and
SciPy, so that a split file is bit for bit the JAX package's); keep the two
in step.  ``main`` takes ``InImage`` from the port's ``coadd`` and
``get_sca_imagefile`` from ``layer_host``.

Counterpart of reference src/pyimcom/splitpsf/splitpsf.py: the PSF is split
with an integrated-Blackman radial window into a compact core G^S (used for
coaddition) and wings; the wings are deconvolved by a WCS-dependent
Gaussian Gamma at the Gauss-Legendre nodes of the Legendre-cube domain,
yielding a kernel K (so the wings can be subtracted from the input images
as K convolved with a Gamma-smoothed coadd) and a small residual zeta.
"""

from __future__ import annotations

import numpy as np
import scipy.signal
from scipy.special import eval_legendre, roots_legendre

from ..config import Settings as Stn
from ..fitsio import HDUList, ImageHDU, fits_read, fits_write
from ..wcsutil import local_partial_pixel_derivatives2


class SplitPSF:
    """
    Decompose one SCA's PSF Legendre cube.

    Parameters
    ----------
    psfcube : (npoly, n, n) Legendre-coefficient PSF cube (oversampled).
    wcs_ : the SCA WCS (for the local distortion of Gamma), or None.
    pars : dict of options (r_in, r_out, sigmaGamma, eps, oversamp, ...).
    """

    @staticmethod
    def window_integrated_blackman(x):
        """C2-smooth step: 0 for x<=-1, 1 for x>=1 (integrated Blackman)."""
        alpha = 0.08
        core = (0.5 * (x + 1)
                + (0.5 * np.sin(np.pi * x) + alpha / 4 * np.sin(2 * np.pi * x))
                / ((1 - alpha) * np.pi))
        return np.where(x >= 1, 1.0, np.where(x <= -1, 0.0, core))

    @staticmethod
    def window_2d(n, r1, r2):
        """Radial window: 1 inside r1, 0 outside r2, smooth between."""
        ax = np.linspace((1 - n) / 2.0, (n - 1) / 2.0, n)
        xx, yy = np.meshgrid(ax, ax)
        r = np.hypot(xx, yy)
        return SplitPSF.window_integrated_blackman(-1.0 + 2.0 / (r2 - r1) * (r2 - r))

    @staticmethod
    def truncate_2d(n, m):
        """Separable edge taper over m pixels on each side."""
        if m == 0:
            return np.ones((n, n))
        X = np.ones(n)
        X[:m] = SplitPSF.window_integrated_blackman(np.linspace(-1.0, 1.0, m + 2))[1:-1]
        X[-m:] = X[m - 1::-1]
        return np.outer(X, X)

    @staticmethod
    def tophatfilter(cube, tophatwidth):
        """Tophat-smooth each plane of a 3D cube (Fourier-space sinc)."""
        npad = int(np.ceil(tophatwidth))
        npad += (4 - npad) % 4
        npl, ny, nx = cube.shape
        out = np.zeros((npl, ny + 2 * npad, nx + 2 * npad))
        out[:, npad:-npad, npad:-npad] = cube
        uy = np.fft.fftfreq(out.shape[1])
        ux = np.fft.fftfreq(out.shape[2])
        s = np.sinc(ux[None, :] * tophatwidth) * np.sinc(uy[:, None] * tophatwidth)
        out = np.real(np.fft.ifft2(np.fft.fft2(out) * s[None]))
        return out[:, npad:-npad, npad:-npad] if npad else out

    @staticmethod
    def gauss_deconv(arr, C, eps=1e-3):
        """Wiener-regularized Gaussian deconvolution (2x2 covariance C)."""
        n = arr.shape[1]
        big = np.zeros((2 * n, 2 * n), dtype=np.complex128)
        big[:n, :n] = arr
        ft = np.fft.fft2(big)
        u_ = np.fft.fftfreq(2 * n)
        u, v = np.meshgrid(u_, u_)
        gwin = np.exp(-2 * np.pi ** 2 * (C[0, 0] * u ** 2 + C[1, 1] * v ** 2
                                         + 2 * C[0, 1] * u * v))
        ft = ft * gwin / (gwin ** 2 + eps ** 2)
        return np.fft.ifft2(ft).real[:n, :n].astype(arr.dtype)

    @staticmethod
    def gauss_stamp(n, C):
        """Centered Gaussian stamp with covariance C (n even)."""
        ax = np.linspace((1 - n) / 2.0, (n - 1) / 2.0, n)
        xx, yy = np.meshgrid(ax, ax)
        detC = C[0, 0] * C[1, 1] - C[0, 1] ** 2
        iC = np.array([[C[1, 1], -C[0, 1]], [-C[0, 1], C[0, 0]]]) / detC
        return np.exp(-0.5 * (iC[0, 0] * xx ** 2 + iC[1, 1] * yy ** 2)
                      - iC[0, 1] * xx * yy) / (2 * np.pi * np.sqrt(detC))

    def __init__(self, psfcube, wcs_, pars):
        self.ref_pixscale = pars.get("ref_pixscale", 0.11)
        self.oversamp = pars.get("oversamp", 8)
        self.tophat_in = pars.get("tophat_in", False)
        self.largestamp_size = psfcube.shape[1]
        self.smallstamp_size = pars.get("smallstamp_size", self.largestamp_size)
        self.nside = pars.get("nside", Stn.sca_nside)
        self.r_in = pars.get("r_in", 4.0)
        self.r_out = pars.get("r_out", 9.0)
        self.sigmaGamma = pars.get("sigmaGamma", 1.0)
        self.eps = pars.get("eps", 0.02)
        self.m_trunc = pars.get("m_trunc", 0)

        self.psfcube = np.copy(psfcube) if self.tophat_in \
            else SplitPSF.tophatfilter(psfcube, self.oversamp)
        self.wcs_ = wcs_

        self.npoly = psfcube.shape[0]
        self.lorder = int(np.round(np.sqrt(self.npoly))) - 1
        if self.smallstamp_size % 2 or self.largestamp_size % 2:
            raise ValueError("SplitPSF requires even dimension")
        if (self.lorder + 1) ** 2 != self.npoly:
            raise ValueError("SplitPSF Legendre polynomial dimension error")

    def build(self):
        """Compute smallpsf (G^S), K_Legendre, per-node K/zeta, and Cov."""
        n = self.largestamp_size
        W = SplitPSF.window_2d(n, self.oversamp * self.r_in, self.oversamp * self.r_out)
        ntrim = (n - self.smallstamp_size) // 2
        self.smallpsf = W[None] * self.psfcube
        if ntrim > 0:
            self.smallpsf = self.smallpsf[:, ntrim:-ntrim, ntrim:-ntrim]
        resid = self.psfcube * (1 - W)[None] * SplitPSF.truncate_2d(n, self.m_trunc)[None]

        xL, wL = roots_legendre(self.lorder + 1)
        xg, yg = (a.ravel() for a in np.meshgrid(xL, xL))
        wg = np.outer(wL, wL).ravel()
        var_ref = (self.oversamp * self.sigmaGamma) ** 2

        self.K_Legendre = np.zeros((self.npoly, n, n))
        self.K_real = np.zeros((self.npoly, n, n))
        self.zeta_real = np.zeros((self.npoly, n, n))
        self.Cov = np.zeros((self.npoly, 2, 2))
        lrange = np.arange(self.lorder + 1)
        for i in range(self.npoly):
            if self.wcs_ is None:
                self.Cov[i] = var_ref * np.identity(2)
            else:
                cpt = [self.nside / 2.0 * (1 + xg[i]), self.nside / 2.0 * (1 + yg[i])]
                jac = local_partial_pixel_derivatives2(self.wcs_, *cpt)
                self.Cov[i] = var_ref * np.linalg.inv(jac.T @ jac) \
                    * (self.ref_pixscale / 3600) ** 2

            lpw = np.outer(eval_legendre(lrange, yg[i]),
                           eval_legendre(lrange, xg[i])).ravel()
            locLRP = np.einsum("a,aij->ij", lpw, resid)
            self.K_real[i] = SplitPSF.gauss_deconv(locLRP, self.Cov[i], eps=self.eps)
            self.zeta_real[i] = locLRP - scipy.signal.convolve(
                self.K_real[i], SplitPSF.gauss_stamp(n, self.Cov[i]),
                mode="same", method="fft")
            self.K_Legendre += wg[i] * np.tensordot(lpw, self.K_real[i], axes=0)

        lnorm = np.outer(lrange + 0.5, lrange + 0.5).ravel()
        self.K_Legendre *= lnorm[:, None, None]


def _load_sca_wcs(path):
    """WCS for one SCA image file (FITS SCI header or Roman L2 ASDF)."""
    from ..wcsutil import WCS

    if path.endswith(".asdf"):
        from ..asdfio import GWCS, asdf_read

        tree = asdf_read(path)
        return GWCS(tree["roman"]["meta"]["wcs"])
    f = fits_read(path)
    for h in f:
        if "CTYPE1" in h.header:
            return WCS.from_header(h.header)
    raise RuntimeError(f"no WCS in {path}")


def split_psf_to_fits(psf_file, wcs_src, pars, outfile):
    """
    Split every SCA's PSF cube in a PSF file and write the combined output
    in the reference layout (reference split_psf_to_fits,
    splitpsf.py:287-397):

    HDU 0           : primary; GSSKIP = nsca, KERSKIP = 2*nsca,
                      ZETASKIP = 3*nsca when pars['SAVEZETA'], global
                      MAXZETA, INWCSxx provenance.
    HDUs 1..nsca    : the original PSF cubes (copied through).
    nsca+1..2*nsca  : short-range cubes G^S (IMTYPE/SCA headers).
    2*nsca+1..3*nsca: wing kernels K (TRUEWCS/MAXZETA/KINT/K2INT headers).
    3*nsca+1..      : zeta residual cubes (only when SAVEZETA).

    wcs_src : None (ignore distortion), a list of per-SCA WCS objects, or a
    format string resolving wcs_src.format(sca) to an image file whose WCS
    is loaded (the reference's wcs_format contract); missing files fall
    back to None.
    """
    hdus_in = fits_read(psf_file)
    prim = ImageHDU(None)
    for key in ["CFORMAT", "PORDER", "ABSCISSA", "NCOEF", "SEQ", "OBSID",
                "NSCA", "OVSAMP", "SIMRUN"]:
        if key in hdus_in[0].header:
            prim.header[key] = hdus_in[0].header[key]
    nsca = int(hdus_in[0].header.get("NSCA", len(hdus_in) - 1))
    prim.header["FROMFILE"] = str(psf_file)
    prim.header["NSCA"] = nsca
    prim.header["GSSKIP"] = nsca
    prim.header["KERSKIP"] = 2 * nsca
    savezeta = bool(pars.get("SAVEZETA", False))
    if savezeta:
        prim.header["ZETASKIP"] = 3 * nsca
    prim.header["SAVEZETA"] = savezeta

    originals, shortranges, kerns, zetas = [], [], [], []
    zetamax = np.zeros(nsca)
    for isca in range(1, nsca + 1):
        if wcs_src is None:
            wcs_ = None
        elif isinstance(wcs_src, str):
            try:
                wcs_ = _load_sca_wcs(wcs_src.format(isca))
                prim.header[f"INWCS{isca:02d}"] = wcs_src.format(isca)
            except (RuntimeError, FileNotFoundError, OSError):
                prim.header[f"INWCS{isca:02d}"] = "/dev/null"
                wcs_ = None
        else:
            wcs_ = wcs_src[isca - 1]
        cube = np.asarray(hdus_in[isca].data, dtype=np.float64)
        sp = SplitPSF(cube, wcs_, pars)
        sp.build()

        originals.append(ImageHDU(cube.astype(np.float32)))
        x = ImageHDU(sp.smallpsf.astype(np.float32))
        x.header["IMTYPE"] = "Short range PSF"
        x.header["SCA"] = isca
        shortranges.append(x)

        y = ImageHDU(sp.K_Legendre.astype(np.float32))
        y.header["IMTYPE"] = "Kernel K"
        y.header["SCA"] = isca
        y.header["TRUEWCS"] = wcs_ is not None
        zetamax[isca - 1] = float(np.amax(np.abs(sp.zeta_real)))
        y.header["MAXZETA"] = zetamax[isca - 1]
        y.header["KINT"] = float(np.sum(sp.K_Legendre[0]) / sp.oversamp ** 2)
        y.header["K2INT"] = float(np.sum(sp.K_Legendre[0] ** 2)
                                  / sp.oversamp ** 2)
        kerns.append(y)

        if savezeta:
            z = ImageHDU(sp.zeta_real.astype(np.float32))
            z.header["IMTYPE"] = "zeta"
            z.header["SCA"] = isca
            zetas.append(z)

    prim.header["MAXZETA"] = float(np.amax(zetamax))
    fits_write(outfile, HDUList([prim] + originals + shortranges + kerns
                                + zetas))
    return outfile


def main(cfgfile, savezeta: bool = False):
    """
    Config-driven PSF splitting (reference splitpsf.main, splitpsf.py:400-
    489): split every in-filter observation's PSF file into
    INLAYERCACHE.psf/psf_{obsid}.fits.
    """
    import json
    import os
    import sys

    from ..coadd import InImage
    from ..layer_host import get_sca_imagefile

    if hasattr(cfgfile, "to_dict"):
        cfg_dict = cfgfile.to_dict()
    else:
        with open(cfgfile) as f:
            cfg_dict = json.load(f)

    if not cfg_dict.get("INLAYERCACHE"):
        raise KeyError("Couldn't find INLAYERCACHE.")
    if cfg_dict["OUTPSF"] != "GAUSSIAN":
        raise ValueError("SplitPSF currently only works for Gaussians.")
    sigma = float(cfg_dict["EXTRASMOOTH"])

    obs = fits_read(cfg_dict["OBSFILE"])[1]
    filters_obs = np.asarray(obs["filter"])
    if filters_obs.dtype.kind in "US":
        conv = np.zeros(len(filters_obs), dtype=np.uint16)
        for j, s in enumerate(Stn.RomanFilters):
            conv[filters_obs == s] = j
        filters_obs = conv
    n_obs = len(filters_obs)

    ovsamp = int(cfg_dict["INPSF"][2])
    r1 = float(cfg_dict["PSFSPLIT"][0])
    r2 = float(cfg_dict["PSFSPLIT"][1])
    epsilon = float(cfg_dict["PSFSPLIT"][2])

    # stamp size: multiple of 8 covering the r2 radius (reference :448-450)
    smallstampsize = int(np.ceil(r2 * ovsamp * 2 + 4))
    smallstampsize += 8 - smallstampsize % 8

    targetdir = cfg_dict["INLAYERCACHE"] + ".psf"
    os.makedirs(targetdir, exist_ok=True)

    use_filter = int(cfg_dict["FILTER"])
    pars = {"smallstamp_size": smallstampsize, "sigmaGamma": sigma,
            "r_in": r1, "r_out": r2, "eps": epsilon, "SAVEZETA": savezeta,
            "oversamp": ovsamp}

    count = 0
    for iobs in range(n_obs):
        psf_file = (cfg_dict["INPSF"][0] + "/"
                    + InImage.psf_filename(cfg_dict["INPSF"][1], iobs))
        # per-SCA WCS format string (sca placeholder from idsca = -1)
        wcs_format = get_sca_imagefile(
            cfg_dict["INDATA"][0], (iobs, -1),
            Stn.RomanFilters[filters_obs[iobs]], cfg_dict["INDATA"][1])
        if os.path.exists(psf_file) and filters_obs[iobs] == use_filter:
            outfile = targetdir + f"/psf_{iobs:d}.fits"
            print(f"{iobs:8d}/{n_obs:8d} found, file is at {psf_file} -->",
                  outfile, flush=True)
            split_psf_to_fits(psf_file, wcs_format, pars, outfile)
            sys.stdout.flush()
            count += 1
    return count


def split_all_psfs(jobs, pars, nworkers: int = None) -> list:
    """
    Split every observation's PSF file (reference
    splitpsf_wrapper.py:14-161).

    jobs : list of (psf_file, wcs_list, outfile) work items; independent,
    so with nworkers > 1 they run in a forkserver process pool (matching
    the reference's executor), otherwise serially in-process.
    """
    if nworkers and nworkers > 1:
        import concurrent.futures as cf
        import multiprocessing as mp

        ctx = mp.get_context("forkserver")
        with cf.ProcessPoolExecutor(max_workers=nworkers,
                                    mp_context=ctx) as ex:
            futs = [ex.submit(split_psf_to_fits, pf, wl, pars, of)
                    for pf, wl, of in jobs]
            return [fu.result() for fu in futs]
    return [split_psf_to_fits(pf, wl, pars, of) for pf, wl, of in jobs]


if __name__ == "__main__":
    # python -m pyimcom_tpu_torch.splitpsf.splitpsf <config.json> [--savezeta]
    import sys

    main(sys.argv[1], savezeta="--savezeta" in sys.argv[2:])
