"""
Truth catalogs for injected sources.

The port's copy of ``pyimcom_tpu/truthcats.py``, so that the port imports
nothing of the JAX package; keep the two in step.

Counterpart of reference src/pyimcom/truthcats.py: regenerates the exact
positions (and, for noisy grids, expected amplitudes) of the simulated
sources that the layer subsystem injected, per mosaic block, and writes
them to a FITS table file.  Because injection grids are deterministic
HEALPix grids (layer.py star grids), the catalog is reproducible from the
configuration alone.
"""

from __future__ import annotations

import re
from os.path import exists

import numpy as np

from .config import Config, Settings as Stn
from .fitsio import HDUList, ImageHDU, TableHDU, fits_write
from .sphere import healpix_patch
from .wcsutil import make_block_wcs

DEG = np.pi / 180.0


def block_truth_positions(cfg, ibx: int, iby: int, res: int):
    """
    Injected-grid sources falling on block (ibx, iby): returns dict of
    columns (ipix, ra, dec, x, y, pa) with x, y in block pixel coordinates
    and pa the local orientation angle in degrees (finite difference at
    +/- 1 arcsec, reference truthcats.py:230-244).
    """
    wcs = make_block_wcs(cfg, ibx, iby)
    ctr = (cfg.NsideP - 1) / 2.0
    ra0, dec0 = wcs.pix2world(np.array([ctr]), np.array([ctr]))
    radius = cfg.NsideP * cfg.dtheta * DEG  # generous block circumradius
    patch = healpix_patch(res, float(ra0[0]) * DEG, float(dec0[0]) * DEG, radius)
    if patch["npix"] == 0:
        return {k: np.zeros(0) for k in ("ipix", "ra", "dec", "x", "y", "pa")}
    ra = patch["rapix"] / DEG
    dec = patch["decpix"] / DEG
    x, y = wcs.world2pix(ra, dec)
    keep = (x > -0.5) & (x < cfg.NsideP - 0.5) & (y > -0.5) & (y < cfg.NsideP - 0.5)
    ra, dec, x, y = ra[keep], dec[keep], x[keep], y[keep]
    xPP, yPP = wcs.world2pix(ra, dec + 1.0 / 3600.0)
    xMM, yMM = wcs.world2pix(ra, dec - 1.0 / 3600.0)
    pa = np.degrees(np.arctan2(xPP - xMM, yPP - yMM))
    pa -= 360.0 * np.floor(pa / 360.0)
    return {
        "ipix": patch["ipix"][keep],
        "ra": ra,
        "dec": dec,
        "x": x,
        "y": y,
        "pa": pa,
    }


def layer_truth_columns(spec: str, ipix: np.ndarray) -> dict:
    """
    Per-object truth morphology/amplitude columns for one injection layer,
    regenerated from the layer's own RNG scheme (reference
    truthcats.py:270-390 uses GalSimInject.genobj; here the columns mirror
    layer.make_extobj_image_from_grid / the nstar amplitude convention).
    """
    from .layer_host import parse_gsext_args

    cols = {}
    head = spec.split(",")[0].lower()
    if head.startswith("gsext"):
        raw = spec.split(",")[1:]
        if head.startswith("gsextchrom") and raw and "=" not in raw[0]:
            raw = raw[1:]
        args = parse_gsext_args(raw)
        n_obj = len(ipix)
        hlr = np.full(n_obj, args["hlr"])
        if args["seed"] is not None:
            # per-object half-light radius: RNG subsequence keyed by the
            # HEALPix index (layer.py make_extobj_image_from_grid)
            for k in range(n_obj):
                sub = np.random.default_rng([args["seed"], int(ipix[k])])
                hlr[k] = args["hlr"] * (0.8 + 0.4 * sub.uniform())
        cols["sersic_n"] = np.full(n_obj, args["n"])
        cols["hlr"] = hlr
        cols["g1"] = np.full(n_obj, args["shape"][0])
        cols["g2"] = np.full(n_obj, args["shape"][1])
        if args["rot"] is not None:
            cols["rot"] = np.full(n_obj, args["rot"])
        if args["shear"] is not None:
            cols["shear1"] = np.full(n_obj, args["shear"][0])
            cols["shear2"] = np.full(n_obj, args["shear"][1])
    elif head.startswith("nstar"):
        parts = spec.split(",")[1:]
        tot_int = float(parts[0]) if parts else 1.0
        cols["amp"] = np.full(len(ipix), tot_int)
    return cols


def gen_truthcats_from_cfg(cfg: Config, outfile: str = None) -> str:
    """
    Generate truth catalogs for every injection layer of a configured run,
    covering all blocks of the mosaic; writes <outstem>_TruthCat.fits.

    Table HDUs are named TRUTH<res>; columns include the block indices so a
    consumer can find each source in its block file.
    """
    cfg()
    layers = {}   # hdu name -> (spec, res)
    for spec in cfg.extrainput[1:]:
        if spec is None:
            continue
        m = re.search(r"^(cstar|gsstar|gstrstar|nstar|gsext|gsextchrom)(\d+)",
                      spec, re.IGNORECASE)
        if m:
            layers[f"TRUTH{int(m.group(2)):d}_{m.group(1).upper()}"] = \
                (spec, int(m.group(2)))

    hdus = HDUList([ImageHDU(None)])
    for hname, (spec, res) in sorted(layers.items()):
        base = ("ipix", "ra", "dec", "x", "y", "pa")
        cols = {k: [] for k in base + ("ibx", "iby")}
        extra_cols = {}
        for ibx in range(cfg.nblock):
            for iby in range(cfg.nblock):
                # only include blocks whose output file exists (partial runs)
                fname = cfg.outstem + f"_{ibx:02d}_{iby:02d}.fits"
                if not exists(fname):
                    continue
                pos = block_truth_positions(cfg, ibx, iby, res)
                npos = len(pos["ipix"])
                for k in base:
                    cols[k].append(pos[k])
                cols["ibx"].append(np.full(npos, ibx, dtype=np.int32))
                cols["iby"].append(np.full(npos, iby, dtype=np.int32))
                for k, v in layer_truth_columns(spec, pos["ipix"]).items():
                    extra_cols.setdefault(k, []).append(v)
        def cat(parts, dtype=None):
            if not parts:
                return np.zeros(0, dtype or np.float64)
            out = np.concatenate(parts)
            return out.astype(dtype) if dtype else out
        x = cat(cols["x"])
        y = cat(cols["y"])
        xi = np.rint(x).astype(np.int32)
        yi = np.rint(y).astype(np.int32)
        data = {
            "ipix": cat(cols["ipix"], np.int64),
            "ra": cat(cols["ra"]),
            "dec": cat(cols["dec"]),
            "pa": cat(cols["pa"]),
            "x": x, "y": y, "xi": xi, "yi": yi,
            "dx": x - xi, "dy": y - yi,
            "ibx": cat(cols["ibx"], np.int32),
            "iby": cat(cols["iby"], np.int32),
        }
        for k, parts in extra_cols.items():
            data[k] = cat(parts)
        t = TableHDU(data=data, name=hname)
        t.header["RESOLUTI"] = res
        t.header["LAYER"] = spec[:60]
        t.header["FILTER"] = Stn.RomanFilters[cfg.use_filter]
        hdus.append(t)

    out = outfile or (cfg.outstem + "_TruthCat.fits")
    fits_write(out, hdus)
    print(f"truth catalog written to {out}")
    return out


def gen_truthcats(pars):
    """List-argument entry point (reference truthcats.py:29 signature)."""
    name, filt, in_prefix, outstem = pars
    cfg = Config(in_prefix + "_00_00.fits", inmode="block")
    if isinstance(filt, int):
        cfg.use_filter = filt
    return gen_truthcats_from_cfg(cfg, outfile=(outstem or None))
