"""
Jax-free twin of survey_fixture.py: the same synthetic miniature survey,
built with pyimcom_tpu_torch's own configuration, FITS, WCS and PSF-model
modules, with the star images drawn by its grid interpolation.

Everything but draw_star is a copy of survey_fixture.py;
tests/test_torch_fixture.py holds the two builders to one survey.
"""

import numpy as np
import torch
from scipy.signal import convolve

from pyimcom_tpu_torch.config import Settings as Stn
from pyimcom_tpu_torch.fitsio import HDUList, Header, ImageHDU, TableHDU, fits_write
from pyimcom_tpu_torch.ops.interp import grid_interp
from pyimcom_tpu_torch.ops.psfmodels import psf_cplx_airy
from pyimcom_tpu_torch.wcsutil import WCS

DEG = np.pi / 180.0

# field geometry (matches the reference fixture scale)
CRA = 60.0504   # mosaic center, degrees
CDEC = -3.8
SRA = 60.0508   # science star, degrees
SDEC = -3.8005

# width of the target PSF in output pixels and input/output area ratio
SIG_OUT = 0.9265328730414752 * 0.11 / 0.04
SC = (0.04 / 0.11) ** 2

CONFIG_TEMPLATE = {
    "OBSFILE": "$DIR/obs.fits",
    "INDATA": ["$DIR/in", "L2_fits"],
    "CTR": [CRA, CDEC],
    "LONPOLE": 240.0,
    "OUTSIZE": [4, 25, 0.04],
    "BLOCK": 2,
    "FILTER": 1,
    "LAKERNEL": "Cholesky",
    "KAPPAC": [5e-4],
    "INPSF": ["$DIR/psf", "L2_fits", 6],
    "EXTRAINPUT": ["cstar14", "whitenoise1", "1fnoise2"],
    "PADSIDES": "all",
    "OUTMAPS": "USTKN",
    "OUT": "$DIR/out/testout_F",
    "INPAD": 0.8,
    "NPIXPSF": 42,
    "FADE": 1,
    "PAD": 0,
    "NOUT": 1,
    "OUTPSF": "GAUSSIAN",
    "EXTRASMOOTH": 0.9265328730414752,
    "INLAYERCACHE": "$DIR/cache/in",
}


def field_angle_to_sky(ra_o, dec_o, pa, FX, FY):
    """
    Sky position of WFI field angle (FX, FY) degrees for a pointing
    (ra_o, dec_o, pa) -- the inverse of the rotation used by the
    observation-cover search (reference coadd.py:1752-1775).
    """
    Xp, Yp = FX * DEG, FY * DEG
    spa, cpa = np.sin(pa * DEG), np.cos(pa * DEG)
    x2 = -spa * Xp - cpa * Yp
    y2 = -cpa * Xp + spa * Yp
    z2 = np.sqrt(1.0 - x2 * x2 - y2 * y2)
    sd, cd = np.sin(dec_o * DEG), np.cos(dec_o * DEG)
    x1 = sd * x2 + cd * z2
    z1 = -cd * x2 + sd * z2
    y1 = y2
    dec_c = np.arcsin(z1) / DEG
    ra_c = ra_o + np.arctan2(y1, x1) / DEG
    return ra_c, dec_c


def pointing_for_field(FX, FY, pa, target_ra=CRA, target_dec=CDEC, iters=5):
    """
    Boresight (ra_o, dec_o) that places (target_ra, target_dec) at WFI field
    angle (FX, FY) for position angle `pa` (fixed-point iteration on the
    field_angle_to_sky map).
    """
    ra_o, dec_o = target_ra, target_dec
    for _ in range(iters):
        pra, pdec = field_angle_to_sky(ra_o, dec_o, pa, FX, FY)
        ra_o -= pra - target_ra
        dec_o -= pdec - target_dec
    return ra_o, dec_o


def make_sca_wcs(ra_o, dec_o, pa, sca):
    """Linear ARC WCS for one SCA of a pointing, using the SCAFov layout."""
    FX, FY = Stn.SCAFov[sca - 1]
    ra_c, dec_c = field_angle_to_sky(ra_o, dec_o, pa, FX, FY)
    s = 0.11 / 3600.0
    rho = pa * DEG
    cd = np.array([[-np.cos(rho), np.sin(rho)],
                   [np.sin(rho), np.cos(rho)]]) * s
    return WCS(ctype=("RA---ARC", "DEC--ARC"), crval=(ra_c, dec_c),
               crpix=(2043.5, 2043.5), cd=cd,
               lonpole=pa - 180.0 if pa >= 180.0 else pa + 180.0)


def draw_star(psf_tophat, xstar, ystar, nside, ov, window=80):
    """
    Unit-flux star image: resample the tophat-convolved oversampled PSF onto
    the native pixel grid around (xstar, ystar), in float64 on the CPU.
    """
    ns_psf = psf_tophat.shape[0]
    ctr = (ns_psf - 1) / 2.0
    im = np.zeros((nside, nside), dtype=np.float32)
    x0 = max(0, int(xstar) - window)
    x1 = min(nside, int(xstar) + window)
    y0 = max(0, int(ystar) - window)
    y1 = min(nside, int(ystar) + window)
    if x1 <= x0 or y1 <= y0:
        return im
    cpu = torch.device("cpu")
    qx = torch.as_tensor((ov * (np.arange(x0, x1) - xstar) + ctr)[None, :],
                         dtype=torch.float64, device=cpu)
    qy = torch.as_tensor((ov * (np.arange(y0, y1) - ystar) + ctr)[None, :],
                         dtype=torch.float64, device=cpu)
    img = torch.as_tensor(psf_tophat, dtype=torch.float64, device=cpu)
    im[y0:y1, x0:x1] = grid_interp(img, qx, qy)[0].numpy()
    return im


def build_survey(tmp_path, n_obs=14, extrainput=None, config_overrides=None):
    """
    Build the synthetic survey under `tmp_path`; returns the config dict
    (with paths substituted).
    """
    import json
    import os

    for sub in ["in", "psf", "cache", "out"]:
        os.makedirs(tmp_path / sub, exist_ok=True)

    # observation table: each F184 pointing places one chosen SCA on the
    # field with a sub-SCA dither and varying roll, emulating a dithered
    # multi-pass survey (same spirit as the reference fixture, which
    # hand-tunes SCA WCSs so ~a dozen exposures cover the field).
    sca_picks = [1, 5, 10, 14, 2, 8, 11, 17, 4, 7, 13, 16]
    rng_f = np.random.default_rng(1234)
    rows = []
    for j in range(n_obs):
        filt = "F184" if j < max(4, n_obs - 2) else "H158"
        pa = 20.0 + 15.0 * (j % 5)
        FX, FY = Stn.SCAFov[sca_picks[j % len(sca_picks)] - 1]
        dx, dy = rng_f.uniform(-0.02, 0.02, size=2)
        ra_o, dec_o = pointing_for_field(FX + dx, FY + dy, pa)
        rows.append((61541 + 0.01 * j, 139.8, ra_o, dec_o, pa, filt))
    obs_tab = TableHDU(data={
        "date": np.array([r[0] for r in rows]),
        "exptime": np.array([r[1] for r in rows]),
        "ra": np.array([r[2] for r in rows]),
        "dec": np.array([r[3] for r in rows]),
        "pa": np.array([r[4] for r in rows]),
        "filter": np.array([r[5] for r in rows]),
    }, name="OBS")
    fits_write(tmp_path / "obs.fits", HDUList([ImageHDU(None), obs_tab]))

    # PSFs: complex-Airy with per-observation features; Legendre cube with
    # only the constant coefficient
    ov = 6
    psfs = []
    for i in range(n_obs):
        psf = psf_cplx_airy(ov * 20, ov * 1.326, sigma=ov * 0.3, features=i % 8)
        psfs.append(psf)
        cube = np.zeros((4,) + psf.shape, dtype=np.float32)
        cube[0] = psf
        hdus = HDUList([ImageHDU(None)] + [ImageHDU(cube) for _ in range(18)])
        fits_write(tmp_path / f"psf/psf_polyfit_{i:d}.fits", hdus)

    # native pixel tophat with wiggled edges (Numerical Recipes trick,
    # reference conftest.py:83-91) for band-limited resampling
    tk = np.ones(ov + 1)
    tk[0] -= 5.0 / 8.0
    tk[-1] -= 5.0 / 8.0
    tk[1] += 1.0 / 6.0
    tk[-2] += 1.0 / 6.0
    tk[2] -= 1.0 / 24.0
    tk[-3] -= 1.0 / 24.0

    nside = Stn.sca_nside
    cdec, cra = CDEC * DEG, CRA * DEG
    for iobs, r in enumerate(rows):
        if r[5] != "F184":
            continue
        psfc = convolve(psfs[iobs], np.outer(tk, tk), mode="same", method="direct")
        for sca in range(1, 19):
            w = make_sca_wcs(r[2], r[3], r[4], sca)
            rapos, decpos = w.pix2world(2043.5, 2043.5)
            mu = (np.sin(cdec) * np.sin(decpos * DEG)
                  + np.cos(cdec) * np.cos(decpos * DEG) * np.cos(rapos * DEG - cra))
            if mu <= np.cos(0.08 * DEG):
                continue
            xstar, ystar = w.world2pix(SRA, SDEC)
            im = draw_star(psfc, float(xstar), float(ystar), nside, ov)

            hdr = Header(w.to_header())
            fits_write(tmp_path / f"in/sim_L2_F184_{iobs:d}_{sca:d}.fits",
                       HDUList([ImageHDU(im, header=hdr)]))
            mask = np.zeros((nside, nside), dtype=np.uint8)
            fits_write(tmp_path / f"in/sim_L2_F184_{iobs:d}_{sca:d}_mask.fits",
                       HDUList([ImageHDU(None), ImageHDU(mask, name="MASK")]))

    cfg = {}
    for k, v in CONFIG_TEMPLATE.items():
        if isinstance(v, str):
            cfg[k] = v.replace("$DIR", str(tmp_path))
        elif isinstance(v, list):
            cfg[k] = [x.replace("$DIR", str(tmp_path)) if isinstance(x, str) else x
                      for x in v]
        else:
            cfg[k] = v
    if extrainput is not None:
        cfg["EXTRAINPUT"] = extrainput
    if config_overrides:
        cfg.update(config_overrides)
    with open(tmp_path / "cfg.json", "w") as f:
        json.dump(cfg, f, indent=1)
    return cfg


def write_piff_files(cube_dir, piff_dir, ov, order=0, grad=0.0, seed=0):
    """
    Each observation's PSF as a Piff file in `piff_dir`
    (pyimcom_tpu_torch.utils.piffutils.write_piff_file's layout), as
    tests/test_piff.py:115-127 writes them: ffov_{obsid}.piff holds one
    PixelGrid solution per SCA whose constant term is plane 0 of that SCA's
    Legendre cube in `cube_dir` (psf_polyfit_{obsid}.fits) smeared by a
    tophat of `ov` samples and scaled by ov**2, on a grid of spacing 1/ov
    native pixel.  With order 1, the u and v terms are the grid's x and y
    derivatives scaled to a seeded fraction of the grid's peak, at most
    `grad`: they move the PSF by a small part of a sample across the chip
    and keep its flux.  Returns the number of files written.
    """
    from pathlib import Path

    from pyimcom_tpu_torch.fitsio import fits_read
    from pyimcom_tpu_torch.ops.psfmodels import smooth_and_pad
    from pyimcom_tpu_torch.utils.piffutils import write_piff_file

    if order not in (0, 1):
        raise ValueError(f"order {order}: the fixture writes orders 0 and 1")
    files = sorted(Path(cube_dir).glob("psf_polyfit_*.fits"))
    for path in files:
        obsid = int(path.stem.rsplit("_", 1)[1])
        rng = np.random.default_rng(seed + obsid)
        f = fits_read(path)
        grids = {}
        for sca in range(1, len(f)):
            sm = smooth_and_pad(np.asarray(f[sca].data, np.float64)[0], tophatwidth=ov) * ov ** 2
            terms = [sm.ravel()]
            if order == 1:
                for axis, c in zip((1, 0), rng.uniform(-grad, grad, 2)):
                    d = np.gradient(sm, axis=axis)
                    terms.append((c * sm.max() / np.abs(d).max() * d).ravel())
            grids[sca - 1] = np.stack(terms, axis=1)
        write_piff_file(str(Path(piff_dir) / f"ffov_{obsid:d}.piff"), grids, sm.shape[0],
                        order=order, scale=1.0 / ov)
    return len(files)


def field_chips(cfg):
    """{obsid: [the SCAs of it with an input image]} of a survey's
    configuration: the chips each observation places on the field."""
    import glob
    import re

    chips = {}
    for path in sorted(glob.glob(cfg["INDATA"][0] + "/*.fits")):
        m = re.search(r"_(\d+)_(\d+)\.fits$", path)
        if m and "_mask" not in path:
            chips.setdefault(int(m.group(1)), []).append(int(m.group(2)))
    return chips


def pixel_twice_sl1(cfg):
    """The science star's SL1 expected where the input PSF holds the pixel
    response once more than the coadd assumes (a Legendre file converted
    from Piff files, whose model includes the pixel, read as L2_2506, which
    the split and the coadd convolve with the pixel tophat again): for
    Gaussians, a star of variance b - s fit with the target of variance b
    gives SL1 = 2 b / (2 b - s); b is the target's variance and s the
    native pixel tophat's (1/12 of a pixel squared), in output pixels."""
    scale = cfg["OUTSIZE"][2] / 0.11                 # output / native pixel side
    b = (cfg["EXTRASMOOTH"] / scale) ** 2
    s = 1.0 / 12.0 / scale ** 2
    return 2.0 * b / (2.0 * b - s)
