"""
Star-based mosaic diagnostics data generators.

The port's copy of ``pyimcom_tpu/diagnostics/starsdata.py``, so that the port imports
nothing of the JAX package; keep the two in step.

Counterparts of reference diagnostics/dynrange.py (radial dynamic-range
profiles around noisy injected stars + noise/coverage histograms) and
diagnostics/starcube_nonoise.py (noiseless star cutout cube with adaptive
and higher moments + fidelity histogram), built on the framework's
self-contained FITS/WCS/HEALPix/moments stack instead of
astropy/healpy/galsim.
"""

from __future__ import annotations

import os
import re

import numpy as np

from ..analysis import unit_to_bels
from ..fitsio import HDUList, ImageHDU, fits_read, fits_write
from ..sphere import healpix_patch
from ..utils.moments import find_adaptive_moments
from ..wcsutil import WCS

DEG = np.pi / 180.0


def _block_config(f):
    """Parse the CONFIG HDU of an open block file into a dict."""
    import json

    return json.loads(" ".join(str(t) for t in f["CONFIG"].data["text"]))


def _star_grid_in_block(wcs_, n, res, rs_rad, bd):
    """
    Injected-star grid positions falling inside the block's science region.

    Returns (ra, dec, x, y) with x/y in block pixels (reference
    dynrange.py:168-196 / starcube_nonoise.py:146-167, via healpy
    query_disc there; RING healpix_patch here).
    """
    ra_c, dec_c = wcs_.pix2world(np.array([(n - 1) / 2.0]),
                                 np.array([(n - 1) / 2.0]))
    patch = healpix_patch(res, float(ra_c[0]) * DEG, float(dec_c[0]) * DEG,
                          rs_rad)
    ra = patch["rapix"] / DEG
    dec = patch["decpix"] / DEG
    if len(ra) == 0:
        return ra, dec, ra, dec
    x, y = wcs_.world2pix(ra, dec)
    xi = np.rint(x).astype(np.int32)
    yi = np.rint(y).astype(np.int32)
    keep = (xi >= bd) & (xi < n - bd) & (yi >= bd) & (yi < n - bd)
    return ra[keep], dec[keep], x[keep], y[keep]


def gen_dynrange_data(infile_fcn, outstem, rpix_try: int = 50,
                      nblockmax: int = 100) -> dict:
    """
    Dynamic-range profiles and noise/coverage histograms over a mosaic
    (reference dynrange.py:28-260).

    infile_fcn(ibx, iby) -> block file path.  Writes
    `outstem+'_sqrtS_hist.dat'` (noise amplification histogram),
    `outstem+'_neff_hist.dat'` (effective coverage histogram), and -- when
    an `nstarRES,flux,bkg,seed` layer exists -- `outstem+'_dynrange.dat'`
    (radius x [1,5,25,50,75,95,99] percentiles of star-profile pixels).
    """
    output = {"SQRTS": None, "NEFF": None, "DYNRANGE": None, "COUNTBLOCK": 0}
    N_noise, d_noise = 100, 0.02
    N_neff, d_neff = 100, 0.1
    countnoise = np.zeros((N_noise, 2))
    countnoise[:, 0] = d_noise * (np.arange(N_noise) + 0.5)
    countneff = np.zeros((N_neff, 2))
    countneff[:, 0] = d_neff * (np.arange(N_neff) + 0.5)
    tnoise = tnoise_gt = tneff = tneff_gt = 0.0

    first = True
    framenumber, res, rs, bd, rpix = 0, 9, 0.0, 0, rpix_try
    nstarlayer = {}
    vals = None

    for iby in range(nblockmax):
        for ibx in range(nblockmax):
            try:
                infile = infile_fcn(ibx, iby)
            except (FileNotFoundError, ValueError):
                continue
            if not os.path.exists(infile):
                continue
            f = fits_read(infile)
            if first:
                first = False
                cfgd = _block_config(f)
                blocksize = (int(cfgd["OUTSIZE"][0]) * int(cfgd["OUTSIZE"][1])
                             * float(cfgd["OUTSIZE"][2]) / 3600.0 * DEG)
                rs = 1.5 * blocksize / np.sqrt(2.0)
                bd = int(cfgd["OUTSIZE"][1]) * int(cfgd["PAD"])
                rpix = min(rpix_try, max(bd - 1, 1))
                vals = [np.zeros(0, dtype=np.float32) for _ in range(rpix)]
                for i, lay in enumerate([""] + list(cfgd["EXTRAINPUT"])):
                    m = re.match(r"^nstar(\d+),([^,]+),([^,]+),([^,]+)$",
                                 str(lay))
                    if m:
                        framenumber = i
                        res = int(m.group(1))
                        nstarlayer = {"RESOLUTION": res,
                                      "FLUX": float(m.group(2)),
                                      "BACKGROUND": float(m.group(3)),
                                      "SEED": int(m.group(4))}

            n = f[0].data.shape[-1]
            wcs_ = WCS.from_header(f[0].header)
            starmap = np.asarray(f[0].data[0, framenumber], dtype=np.float32)

            try:
                h = f["SIGMA"]
                sig = 10.0 ** (0.5 * unit_to_bels(h.header["UNIT"])
                               * h.data[0, bd:n - bd, bd:n - bd])
                idx = np.clip((sig / d_noise).astype(np.int64), 0, N_noise)
                cnt = np.bincount(idx.ravel(), minlength=N_noise + 1)
                countnoise[:, 1] += cnt[:N_noise]
                tnoise += sig.size
                tnoise_gt += int(cnt[N_noise])
            except (KeyError, ValueError):
                pass
            try:
                h = f["EFFCOVER"]
                nef = 10.0 ** (unit_to_bels(h.header["UNIT"])
                               * h.data[0, bd:n - bd, bd:n - bd])
                idx = np.clip((nef / d_neff).astype(np.int64), 0, N_neff)
                cnt = np.bincount(idx.ravel(), minlength=N_neff + 1)
                countneff[:, 1] += cnt[:N_neff]
                tneff += nef.size
                tneff_gt += int(cnt[N_neff])
            except (KeyError, ValueError):
                pass

            if framenumber > 0:
                _ra, _dec, x, y = _star_grid_in_block(wcs_, n, res, rs, bd)
                yy, xx = np.mgrid[0:n, 0:n]
                for xs, ys in zip(x, y):
                    x0 = int(np.clip(np.floor(xs) - rpix - 1, 0, n))
                    x1 = int(np.clip(np.ceil(xs) + rpix + 1, 0, n))
                    y0 = int(np.clip(np.floor(ys) - rpix - 1, 0, n))
                    y1 = int(np.clip(np.ceil(ys) + rpix + 1, 0, n))
                    r = np.floor(np.hypot(xx[y0:y1, x0:x1] - xs,
                                          yy[y0:y1, x0:x1] - ys)).astype(int)
                    sub = starmap[y0:y1, x0:x1]
                    for j in range(rpix):
                        vals[j] = np.concatenate([vals[j], sub[r == j]])
            output["COUNTBLOCK"] += 1

    if output["COUNTBLOCK"] == 0:
        return output

    if os.path.dirname(outstem):
        os.makedirs(os.path.dirname(outstem), exist_ok=True)
    if framenumber > 0 and vals is not None and vals[0].size:
        lines = []
        for j in range(rpix):
            row = f"{j:3d} {vals[j].size:8d}"
            for q in (1, 5, 25, 50, 75, 95, 99):
                row += f" {np.percentile(vals[j], q):12.5E}"
            lines.append(row)
        ofile = outstem + "_dynrange.dat"
        with open(ofile, "w") as fn:
            fn.write("\n".join(lines) + "\n")
        output["DYNRANGE"] = ofile

    ofile = outstem + "_sqrtS_hist.dat"
    hdr = f" {countnoise[:, 1].max():11.5E} " \
          f"{100 * tnoise_gt / max(tnoise, 1):9.6f}"
    np.savetxt(ofile, countnoise, header=hdr)
    output["SQRTS"] = ofile
    output["SQRTS_HEADER"] = (countnoise[:, 1].max(),
                              100 * tnoise_gt / max(tnoise, 1))
    ofile = outstem + "_neff_hist.dat"
    hdr = f" {countneff[:, 1].max():11.5E} " \
          f"{100 * tneff_gt / max(tneff, 1):9.6f}"
    np.savetxt(ofile, countneff, header=hdr)
    output["NEFF"] = ofile
    output["NEFF_HEADER"] = (countneff[:, 1].max(),
                             100 * tneff_gt / max(tneff, 1))
    output["NSTARLAYER"] = nstarlayer
    return output


def gen_starcube_nonoise(infile_fcn, outstem, nblockmax: int = 100) -> dict:
    """
    Noiseless star cutout cube + moment catalog + fidelity histogram
    (reference starcube_nonoise.py:28-266).

    Catalog columns (22, matching the reference order): ra, dec, ibx, iby,
    x, y, xi, yi, dx, dy, amp, dxc, dyc, sigma, g1, g2, M4p (u^4-v^4
    moment), M4c (cross), forced-scale e1, e2, fidelity (dB, mean over the
    central box), coverage.
    """
    output = {"STARCAT": None, "FIDHIST": None}
    bd, bd2 = 40, 8
    ncol = 22
    pos = np.zeros((0, ncol))
    cube = np.zeros((0, 1, 1), dtype=np.float32)
    fhist = np.zeros(81, dtype=np.int64)
    first = True
    use_slice, res, rs, bdpad, n2, force_scale = -1, 9, 0.0, 0, 1, 1.0

    for ibx in range(nblockmax):
        for iby in range(nblockmax):
            try:
                infile = infile_fcn(ibx, iby)
            except (FileNotFoundError, ValueError):
                continue
            if not os.path.exists(infile):
                continue
            f = fits_read(infile)
            if first:
                first = False
                cfgd = _block_config(f)
                n = f[0].data.shape[-1]
                blocksize = (int(cfgd["OUTSIZE"][0]) * int(cfgd["OUTSIZE"][1])
                             * float(cfgd["OUTSIZE"][2]) / 3600.0 * DEG)
                rs = 1.5 * blocksize / np.sqrt(2.0)
                n2 = int(cfgd["OUTSIZE"][1])
                outscale = float(cfgd["OUTSIZE"][2])
                force_scale = 0.40 / outscale
                bdpad = n2 * int(cfgd["PAD"])
                bd = min(bd, n2)
                for i, lay in enumerate([""] + list(cfgd["EXTRAINPUT"])):
                    m = re.match(r"^(?:gsstar|cstar)(\d+)$", str(lay))
                    if m:
                        use_slice = i
                        res = int(m.group(1))
                cube = np.zeros((0, 2 * bd - 1, 2 * bd - 1), dtype=np.float32)
            if use_slice < 0:
                return output

            n = f[0].data.shape[-1]
            wcs_ = WCS.from_header(f[0].header)
            smap = np.asarray(f[0].data[0, use_slice], dtype=np.float64)
            wt = np.sum(np.asarray(f["INWEIGHT"].data[0]) > 0.01, axis=0)
            fh = f["FIDELITY"]
            fmap = np.floor(np.asarray(fh.data[0], dtype=np.float32)
                            * unit_to_bels(fh.header["UNIT"]) / (-0.1)
                            ).astype(np.int16)
            inner = fmap[bdpad:n - bdpad, bdpad:n - bdpad]
            fhist += np.bincount(np.clip(inner, 0, 80).ravel(), minlength=81)

            ra, dec, x, y = _star_grid_in_block(wcs_, n, res, rs, bdpad)
            npix = len(x)
            if npix == 0:
                continue
            xi = np.rint(x).astype(np.int32)
            yi = np.rint(y).astype(np.int32)
            dx, dy = x - xi, y - yi
            newpos = np.zeros((npix, ncol))
            newpos[:, 0], newpos[:, 1] = ra, dec
            newpos[:, 2], newpos[:, 3] = ibx, iby
            newpos[:, 4], newpos[:, 5] = x, y
            newpos[:, 6], newpos[:, 7] = xi, yi
            newpos[:, 8], newpos[:, 9] = dx, dy
            newimg = np.zeros((npix, 2 * bd - 1, 2 * bd - 1), dtype=np.float32)
            padmap = np.pad(smap, bd)
            for k in range(npix):
                newimg[k] = padmap[yi[k] + 1:yi[k] + 2 * bd,
                                   xi[k] + 1:xi[k] + 2 * bd]
                mom = find_adaptive_moments(newimg[k])
                if not mom.converged:
                    continue
                newpos[k, 10] = mom.moments_amp
                newpos[k, 11] = mom.x0 - (bd - 1) - dx[k]
                newpos[k, 12] = mom.y0 - (bd - 1) - dy[k]
                newpos[k, 13] = mom.moments_sigma
                # reduced shear from the adaptive covariance
                tr = mom.Mxx + mom.Myy
                det = mom.Mxx * mom.Myy - mom.Mxy ** 2
                denom = tr + 2.0 * np.sqrt(max(det, 0.0))
                newpos[k, 14] = (mom.Mxx - mom.Myy) / denom
                newpos[k, 15] = 2.0 * mom.Mxy / denom

                # higher moments in the adaptive-Gaussian frame
                # (reference starcube_nonoise.py:210-227)
                yy, xx = np.mgrid[0:2 * bd - 1, 0:2 * bd - 1].astype(float)
                xx -= mom.x0
                yy -= mom.y0
                D = det
                if D > 0:
                    zeta = D * (tr + 2 * np.sqrt(D))
                    u_ = ((mom.Myy + np.sqrt(D)) * xx - mom.Mxy * yy) \
                        / np.sqrt(zeta)
                    v_ = ((mom.Mxx + np.sqrt(D)) * yy - mom.Mxy * xx) \
                        / np.sqrt(zeta)
                    wti = newimg[k] * np.exp(-0.5 * (u_ ** 2 + v_ ** 2))
                    sw = wti.sum()
                    if sw > 0:
                        newpos[k, 16] = np.sum(wti * (u_ ** 4 - v_ ** 4)) / sw
                        newpos[k, 17] = 2 * np.sum(
                            wti * (u_ ** 3 * v_ + u_ * v_ ** 3)) / sw
                wti2 = newimg[k] * np.exp(-0.5 * (xx ** 2 + yy ** 2)
                                          / force_scale ** 2)
                s2 = wti2.sum()
                if s2 > 0:
                    newpos[k, 18] = np.sum(wti2 * (xx ** 2 - yy ** 2)) \
                        / s2 / force_scale ** 2
                    newpos[k, 19] = np.sum(wti2 * 2 * xx * yy) \
                        / s2 / force_scale ** 2
                newpos[k, 20] = np.mean(fmap[yi[k] + 1 - bd2:yi[k] + bd2,
                                             xi[k] + 1 - bd2:xi[k] + bd2])
                newpos[k, 21] = wt[yi[k] // n2, xi[k] // n2]
            pos = np.concatenate([pos, newpos])
            cube = np.concatenate([cube, newimg])

    if pos.shape[0] == 0:
        return output
    if os.path.dirname(outstem):
        os.makedirs(os.path.dirname(outstem), exist_ok=True)
    fits_write(outstem + "_StarCat_cube.fits",
               HDUList([ImageHDU(cube.astype(np.float32))]))
    ofile = outstem + "_StarCat.txt"
    np.savetxt(ofile, pos, header=f" {np.median(pos[:, 13]):14.8E}")
    output["STARCAT"] = ofile

    ofile = outstem + "_fidHist.txt"
    tot = max(fhist.sum(), 1)
    with open(ofile, "w") as fn:
        for fy in range(20, 81):
            fn.write(f"{fy:2d} {fhist[fy] / tot:8.6f} "
                     f"{fhist[:fy + 1].sum() / tot:8.6f}\n")
    output["FIDHIST"] = ofile
    return output
