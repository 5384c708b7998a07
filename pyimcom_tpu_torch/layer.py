"""
Input layer cubes and star injection on PyTorch.

Counterpart of pyimcom_tpu/layer.py.  Star injection (``cstar``,
``gsstar``, ``gstrstar``, ``gsfdstar``, ``nstar`` layers) draws each star by
D5512 interpolation of its oversampled PSF through the dense entry, so on
the card the patches of a chunk of stars are one launch of kernel K1.
Galaxy injection (``gsext``, ``gsextchrom`` layers) convolves each PSF with
the analytic galaxy profile on the host (NumPy FFT) and resamples the
result the same way.  The layer dispatch and the cache-backed
:func:`get_all_data` follow the JAX package's so that they call these
injectors; the host helpers they use -- file readers, seeds, noise frames,
the star grid, the galaxy profiles, masks -- are in :mod:`.layer_host`.
"""

from __future__ import annotations

import os
import re
import sys
from os.path import exists

import numpy as np
import torch
from filelock import FileLock, Timeout

from .config import Settings as Stn
from .device import DTYPE
from .fitsio import HDUList, ImageHDU, fits_read, fits_write
from .layer_host import (
    _sciwcs_hdu,
    _shear_expm,
    _shear_matrix,
    galaxy_ft,
    generate_star_grid,
    get_sca_imagefile,
    layer_seed,
    noise_1f_frame,
    parse_gsext_args,
    read_sci_frame,
)
from .ops import psfmodels
from .ops.interp import interp2d_dense
from .wcsutil import local_partial_pixel_derivatives2


_GUARD = 6    # interpolation guard padding around each oversampled image


def _padded_stack(frames, p=_GUARD):
    """(ns, shp + 2p, shp + 2p) stack of the frames, each centred in its
    shp x shp slot (shp the largest frame)."""
    shp = max(f.shape[0] for f in frames)
    stack = np.zeros((len(frames), shp + 2 * p, shp + 2 * p))
    for k, f in enumerate(frames):
        o = (shp - f.shape[0]) // 2
        stack[k, p + o:p + o + f.shape[0], p + o:p + o + f.shape[1]] = f
    return stack


def _draw_patches(stack, xsca, ysca, ov, patch_half, device):
    """Resample one chunk of objects: object k is the oversampled image
    stack[k] (from :func:`_padded_stack`) centred at SCA pixel (xsca[k],
    ysca[k]), drawn on a (2*patch_half)^2 pixel patch by one dense
    interpolation (kernel K1 on the card).  Returns the patch values (ns,
    P, P) and their pixel grids gx, gy."""
    ns = len(xsca)
    p = _GUARD
    ctr = (stack.shape[1] - 2 * p - 1) / 2.0
    x0 = np.clip(np.floor(xsca).astype(int) - patch_half, 0, None)
    y0 = np.clip(np.floor(ysca).astype(int) - patch_half, 0, None)
    P = 2 * patch_half
    gx = x0[:, None, None] + np.arange(P)[None, None, :]
    gy = y0[:, None, None] + np.arange(P)[None, :, None]
    qx = ov * (gx - xsca[:, None, None]) + ctr + p
    qy = ov * (gy - ysca[:, None, None]) + ctr + p
    qx, qy = np.broadcast_arrays(qx, qy)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=DTYPE, device=device)

    vals = interp2d_dense(put(stack), put(qx.reshape(ns, -1)), put(qy.reshape(ns, -1)))
    return vals.cpu().numpy().reshape(ns, P, P) * ov ** 2, gx, gy


def _add_patches(image, vals, gx, gy):
    """Add the patches of :func:`_draw_patches` into `image`, dropping
    pixels beyond the SCA."""
    nside, P = image.shape[0], vals.shape[1]
    inb = (gx < nside) & (gy < nside)
    for k in range(len(vals)):
        m = inb[k]
        np.add.at(image, (gy[k].repeat(P, axis=1)[m], gx[k].repeat(P, axis=0)[m]),
                  vals[k][m])


def make_image_from_grid(res, inpsf, idsca, obsdata, mywcs, nside_sca,
                         inpsf_oversamp, *, device, patch_half: int = 64,
                         chunk: int = 32, flux_fn=None):
    """
    Draw a star at every HEALPix grid point by interpolating the
    oversampled PSF (reference GridInject.make_image_from_grid,
    layer.py:791-854): each chunk of stars is one dense interpolation of
    (chunk, 2*patch_half, 2*patch_half) points on `device`.
    `flux_fn(xsca, ysca) -> (nstar,)` sets per-star fluxes (default unit).
    """
    image = np.zeros((nside_sca, nside_sca), dtype=np.float64)
    ipix, xsca, ysca, rapix, decpix = generate_star_grid(res, mywcs)
    if len(ipix) == 0:
        return image
    d = patch_half
    # keep stars whose patch intersects the SCA
    keep = (xsca > -d) & (xsca < nside_sca + d) & (ysca > -d) & (ysca < nside_sca + d)
    idx = np.nonzero(keep)[0]

    inpsf_batch = getattr(getattr(inpsf, "__self__", None),
                          "get_psf_pos_batch", None)
    for start in range(0, len(idx), chunk):
        sel = idx[start:start + chunk]
        if inpsf_batch is not None:
            psfs = list(inpsf_batch(np.stack([rapix[sel], decpix[sel]], axis=-1),
                                    use_drawpsf=True))
        else:
            psfs = [np.asarray(inpsf((rapix[i], decpix[i]), use_drawpsf=True))
                    for i in sel]
        vals, gx, gy = _draw_patches(_padded_stack(psfs), xsca[sel], ysca[sel],
                                     inpsf_oversamp, d, device)
        if flux_fn is not None:
            vals = vals * np.asarray(flux_fn(xsca[sel], ysca[sel]))[:, None, None]
        _add_patches(image, vals, gx, gy)
    return image


def make_extobj_image_from_grid(res, inimage, nside_sca, inpsf_oversamp, args, *,
                                device, patch_half: int = 64, chunk: int = 16,
                                psf_source=None):
    """
    Draw unit-flux extended objects at every grid point (reference
    make_extobj_image_from_grid, GalSim-free counterpart of GalSimInject
    .galsim_extobj_grid): each oversampled PSF is convolved with the
    analytic sheared galaxy profile in Fourier space on the host, then the
    chunk is resampled like stars, one dense interpolation (kernel K1) per
    chunk.  `args` from ``parse_gsext_args``; `psf_source(points)` replaces
    the run PSF (the chromatic variant).
    """
    image = np.zeros((nside_sca, nside_sca), dtype=np.float64)
    ipix, xsca, ysca, rapix, decpix = generate_star_grid(res, inimage.inwcs)
    if len(ipix) == 0:
        return image
    ov = inpsf_oversamp
    d = patch_half

    # morphology transformation in sky coordinates
    M = _shear_matrix(*args["shape"])
    if args["rot"] is not None:
        th = args["rot"] * np.pi / 180.0
        M = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]) @ M
    if args["shear"] is not None:
        M = _shear_expm(*args["shear"]) @ M

    # local sample -> sky Jacobian at the SCA center (arcsec per sample)
    ctr_pix = (nside_sca - 1) / 2.0
    A_samp2sky = local_partial_pixel_derivatives2(inimage.inwcs, ctr_pix, ctr_pix) \
        * 3600.0 / ov

    keep = (xsca > -d) & (xsca < nside_sca + d) & (ysca > -d) & (ysca < nside_sca + d)
    idx = np.nonzero(keep)[0]
    batch_fn = getattr(inimage, "get_psf_pos_batch", None)
    for start in range(0, len(idx), chunk):
        sel = idx[start:start + chunk]
        points = np.stack([rapix[sel], decpix[sel]], axis=-1)
        if psf_source is not None:
            psfs = list(psf_source(points))
        elif batch_fn is not None:
            psfs = list(batch_fn(points, use_drawpsf=True))
        else:
            psfs = [np.asarray(inimage.get_psf_pos((rapix[i], decpix[i]),
                                                   use_drawpsf=True)) for i in sel]
        frames = _padded_stack(psfs, p=0)
        shp = frames.shape[1]
        uy = np.fft.fftfreq(shp)[:, None]
        ux = np.fft.rfftfreq(shp)[None, :]
        convs = []
        for k, frame in enumerate(frames):
            hlr_k = args["hlr"]
            if args["seed"] is not None:
                # reproducible per-object size (RNG subsequence keyed by the
                # HEALPix index, cf. reference GalSimInject.subgen)
                sub = np.random.default_rng([args["seed"], int(ipix[sel[k]])])
                hlr_k = args["hlr"] * (0.8 + 0.4 * sub.uniform())
            gft = galaxy_ft(ux, uy, args["n"], hlr_k, M, A_samp2sky)
            convs.append(np.fft.irfft2(np.fft.rfft2(frame) * gft, s=(shp, shp)))
        vals, gx, gy = _draw_patches(_padded_stack(convs), xsca[sel], ysca[sel],
                                     ov, d, device)
        _add_patches(image, vals, gx, gy)
    return image


def _build_extra_layer(spec: str, inimage) -> np.ndarray | None:
    """Build one extra input layer from its EXTRAINPUT spec string."""
    cfg = inimage.blk.cfg
    idsca = inimage.idsca
    obsdata = inimage.blk.obsdata
    device = inimage.blk.device
    nside = Stn.sca_nside

    m = re.search(r"^whitenoise(\d+)$", spec, re.IGNORECASE)
    if m:
        seed = layer_seed(int(m.group(1)), idsca)
        rng = np.random.default_rng(seed)
        return rng.normal(size=(nside, nside)).astype(np.float32)

    m = re.search(r"^1fnoise(\d+)$", spec, re.IGNORECASE)
    if m:
        return noise_1f_frame(layer_seed(int(m.group(1)), idsca))

    m = re.search(r"^(cstar|gsstar|gstrstar)(\d+)$", spec, re.IGNORECASE)
    if m:
        # 'gsstar'/'gstrstar' are drawn with the same interpolation as
        # 'cstar'; the angle-transient variant ('gstrstar') injects only for
        # one of the two pass angles.
        if m.group(1).lower() == "gstrstar":
            pa = float(obsdata["pa"][idsca[0]])
            if not pa < 90.0:  # transient present in first-pass geometry only
                return np.zeros((nside, nside), dtype=np.float32)
        res = int(m.group(2))
        return make_image_from_grid(res, inimage.get_psf_pos, idsca, obsdata,
                                    inimage.inwcs, nside, cfg.inpsf_oversamp,
                                    device=device).astype(np.float32)

    m = re.search(r"^gsfdstar(\d+),(.+)$", spec, re.IGNORECASE)
    if m:
        # field-dependent star flux: 1 at the FPA center rising to 1+amp at
        # the corners (reference layer.py:1419-1434, 273-276)
        from .config import fpaCoords

        res = int(m.group(1))
        amp = float(m.group(2))
        sca = idsca[1]

        def flux_fn(xs, ys):
            xf, yf = fpaCoords.pix2fpa(sca, xs, ys)
            return 1.0 + amp * (xf ** 2 + yf ** 2) / fpaCoords.Rfpa ** 2

        return make_image_from_grid(res, inimage.get_psf_pos, idsca, obsdata,
                                    inimage.inwcs, nside, cfg.inpsf_oversamp,
                                    device=device, flux_fn=flux_fn
                                    ).astype(np.float32)

    m = re.search(r"^(gsext|gsextchrom)(\d+)(,|$)", spec, re.IGNORECASE)
    if m:
        res = int(m.group(2))
        raw = spec.split(",")[1:]
        psf_source = None
        if m.group(1).lower() == "gsextchrom" and raw and "=" not in raw[0]:
            # chromatic variant: inject with the PSF cube from the given
            # directory instead of the run PSF (reference layer.py:1446-1456)
            fname = raw[0] + f"/psf_polyfit_{idsca[0]:d}.fits"
            raw = raw[1:]
            if not exists(fname):
                # a missing chromatic cube is a configuration mistake: the
                # reference opens the file unconditionally and raises
                raise FileNotFoundError(
                    f"gsextchrom: chromatic PSF cube {fname} not found "
                    f"(layer spec {spec!r})")
            cube = np.asarray(fits_read(fname)[idsca[1]].data, dtype=np.float64)

            def psf_source(points):
                px, py = inimage.inwcs.world2pix(points[:, 0], points[:, 1])
                psfs = psfmodels.eval_psf_cube_batch(cube, px, py, nside=nside)
                return psfmodels.smooth_and_pad_batch(
                    psfs, tophatwidth=cfg.inpsf_oversamp)
        return make_extobj_image_from_grid(
            res, inimage, nside, cfg.inpsf_oversamp, parse_gsext_args(raw),
            device=device, psf_source=psf_source).astype(np.float32)

    m = re.search(r"^nstar(\d+),", spec, re.IGNORECASE)
    if m:
        res = int(m.group(1))
        extargs = spec.split(",")[1:]
        tot_int, bg, q = float(extargs[0]), float(extargs[1]), int(extargs[2])
        rng = np.random.default_rng(layer_seed(q, idsca))
        brightness = make_image_from_grid(res, inimage.get_psf_pos, idsca, obsdata,
                                          inimage.inwcs, nside, cfg.inpsf_oversamp,
                                          device=device)
        lam = brightness * tot_int + bg
        lam_c = np.clip(lam, 0, None)
        return (rng.poisson(lam=lam_c) - lam_c + lam - bg).astype(np.float32)

    m = re.search(r"^noise,(\S+)$", spec, re.IGNORECASE)
    if m:
        # saved noise realizations from the L2 preprocessing (reference
        # layer.py:1460-1490): pick the slice whose label matches
        noiselabel = m.group(1)
        filename = get_sca_imagefile(cfg.inpath, idsca, obsdata, cfg.informat,
                                     extraargs={"type": "noise"})
        if filename and exists(filename):
            if filename.endswith(".asdf"):
                from .asdfio import asdf_read

                tree = asdf_read(filename)
                labels = list(tree["config"]["NOISE"]["LAYER"])
                data = np.asarray(tree["noise"])
            else:
                f = fits_read(filename)
                labels = [str(f[0].header.get(f"NOISE{j:d}", "")).strip()
                          for j in range(len(f) - 0)]
                data = np.asarray(f[0].data)
            jn_use = -1
            for jn, lab in enumerate(labels):
                if lab == noiselabel and jn_use < 0:
                    jn_use = jn
            if jn_use < 0:
                print(f"noise layer {noiselabel!r} not found in {filename}",
                      flush=True)
                return np.zeros((nside, nside), dtype=np.float32)
            sl = data[jn_use] if data.ndim == 3 else data
            return np.asarray(sl[:nside, :nside], dtype=np.float32)
        return np.zeros((nside, nside), dtype=np.float32)

    if spec.casefold() == "truth" or spec.lower().startswith("truth,"):
        rescale = 1.0
        mm = re.search(r"^truth,(.+)$", spec, re.IGNORECASE)
        if mm:
            rescale = float(mm.group(1))
        filename = get_sca_imagefile(cfg.inpath, idsca, obsdata, cfg.informat,
                                     extraargs={"type": "truth"})
        if filename and exists(filename):
            layer = np.asarray(fits_read(filename)[0].data, dtype=np.float32)
            return layer * rescale
        return None

    if spec.casefold() == "labnoise":
        filename = get_sca_imagefile(cfg.inpath, idsca, obsdata, cfg.informat,
                                     extraargs={"type": "labnoise"})
        if filename and exists(filename):
            data = np.asarray(fits_read(filename)[0].data, dtype=np.float32)
            if data.shape[0] == 4096:
                data = data[4:4092, 4:4092]
            return data
        print("Warning: labnoise file not found, skipping ...")
        return None

    if spec.casefold() == "skyerr":
        filename = get_sca_imagefile(cfg.inpath, idsca, obsdata, cfg.informat,
                                     extraargs={"type": "skyerr"})
        if filename and exists(filename):
            hdus = fits_read(filename)
            return (np.asarray(hdus["ERR"].data, dtype=np.float32)
                    - float(hdus["SCI"].header["SKY_MEAN"]))
        return None

    raise ValueError(f"unsupported EXTRAINPUT layer spec: {spec!r}")


def get_all_data(inimage, timeout: float = 300.0) -> None:
    """
    Fill inimage.indata with the (n_inframe, nside, nside) layer cube,
    loading from / saving to the INLAYERCACHE when configured (with file
    locks for cross-process safety; reference layer.py:1199-1529).
    """
    cfg = inimage.blk.cfg
    idsca = inimage.idsca
    nside = Stn.sca_nside

    cache_path = None
    if cfg.inlayercache:
        cache_path = cfg.inlayercache + f"_{idsca[0]:08d}_{idsca[1]:02d}.fits"
        lock = FileLock(cache_path + ".lock")
        try:
            with lock.acquire(timeout=30):
                if exists(cache_path):
                    print("loading input layer <<", cache_path)
                    inimage.indata = np.asarray(fits_read(cache_path)[0].data,
                                                dtype=np.float32)
                    sys.stdout.flush()
                    return
        except Timeout:
            pass

    indata = np.zeros((cfg.n_inframe, nside, nside), dtype=np.float32)
    filename = get_sca_imagefile(cfg.inpath, idsca, inimage.blk.obsdata, cfg.informat)
    if filename and exists(filename):
        indata[0] = read_sci_frame(filename, cfg.informat)

    inimage.indata = indata
    for i in range(1, cfg.n_inframe):
        layer = _build_extra_layer(cfg.extrainput[i], inimage)
        if layer is not None:
            indata[i] = layer

    if cache_path is not None:
        try:
            with lock.acquire(timeout=timeout):
                print("saving input layer >>", cache_path)
                os.makedirs(os.path.dirname(cache_path), exist_ok=True)
                hdus = [ImageHDU(indata)]
                sciwcs = _sciwcs_hdu(inimage, filename)
                if sciwcs is not None:
                    hdus.append(sciwcs)
                fits_write(cache_path, HDUList(hdus))
        except Timeout:
            pass
    sys.stdout.flush()
