"""
PNG mosaic pictures from coadded block files.

The port's copy of ``pyimcom_tpu/pictures/genpic.py``, so that the port imports
nothing of the JAX package; keep the two in step.

Counterpart of reference src/pyimcom/pictures/genpic.py: asinh/linear
stretches of one layer over a block grid, optionally binned and colored
with a matplotlib colormap, written with PIL.
"""

from __future__ import annotations

import os

import numpy as np

from ..compress import ReadFile
from ..config import Config


def cmapscale(inarray, srange, cmap=None, stretch="asinh"):
    """
    Map a float image to display bytes: grayscale (cmap=None) or RGB.

    srange : (min, max) values; beyond saturates.  stretch: 'asinh'|'linear'.
    """
    lsmin, lsmax = srange
    med = np.clip(inarray, lsmin, lsmax)
    if stretch == "asinh":
        out = (np.arcsinh(med / np.abs(lsmin)) - np.arcsinh(-1)) / (
            np.arcsinh(lsmax / np.abs(lsmin)) - np.arcsinh(-1))
    elif stretch == "linear":
        out = (med - lsmin) / (lsmax - lsmin)
    else:
        raise ValueError("Unrecognized stretch type: " + stretch)
    out = np.clip(out, 0, 1)
    if cmap is None:
        return np.clip(np.rint(255 * out), 0, 255).astype(np.uint8)
    from matplotlib import colormaps

    return (colormaps[cmap](out) * 255).astype(np.uint8)[:, :, :3]


def _bin(img, b):
    if b == 1:
        return img
    ny, nx = img.shape
    return img[:ny - ny % b, :nx - nx % b].reshape(ny // b, b, nx // b, b).mean(axis=(1, 3))


def make_picture_1band(fn, outfile, layer=0, bounds=None, binning=1, cmap=None,
                       srange=(-8.0, 600.0), stretch="asinh"):
    """
    Write a mosaic PNG from the block files <fn>_XX_YY.fits.

    bounds : [ymin, ymax, xmin, xmax] block ranges, or None for all.
    """
    import glob as _glob

    candidates = sorted(_glob.glob(fn + "_[0-9][0-9]_[0-9][0-9].fits"))
    if not candidates:
        raise FileNotFoundError(f"no block files matching {fn}_XX_YY.fits")
    cfg = Config(candidates[0], inmode="block")
    nint = cfg.n1 * cfg.n2
    pad = cfg.n2 * cfg.postage_pad
    if nint % binning:
        raise ValueError(f"can't bin {nint} in groups of {binning}")

    if bounds is None:
        ymin, ymax, xmin, xmax = 0, cfg.nblock, 0, cfg.nblock
    else:
        ymin, ymax, xmin, xmax = bounds

    bw = cmap is None
    ncolor = 1 if bw else 3
    npix = nint // binning
    cube = np.zeros(((ymax - ymin) * npix, (xmax - xmin) * npix, ncolor), dtype=np.uint8)

    for ix in range(xmax - xmin):
        for iy in range(ymax - ymin):
            fname = fn + f"_{ix + xmin:02d}_{iy + ymin:02d}.fits"
            if not os.path.exists(fname):
                continue
            f = ReadFile(fname)
            img = np.asarray(f[0].data[0, layer])
            if pad > 0:
                img = img[pad:-pad, pad:-pad]
            img = _bin(img, binning)
            sl = np.s_[iy * npix:(iy + 1) * npix, ix * npix:(ix + 1) * npix]
            mapped = cmapscale(img, srange, cmap=cmap, stretch=stretch)
            cube[sl] = mapped[..., None] if bw else mapped

    from PIL import Image

    arr = cube[::-1, :, 0] if bw else cube[::-1]
    Image.fromarray(arr).save(outfile)
    return outfile
