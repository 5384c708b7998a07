"""
Wing subtraction on PyTorch: remove K (*) (coadded mosaic) from cached input
exposures.

Counterpart of pyimcom_tpu/splitpsf/imsubtract.py.  For each exposure the
Tukey-windowed mosaic blocks are resampled onto an oversampled canvas in the
exposure's frame with G4460 interpolation (kernel K1 in its 8-tap form on the
card), each Legendre-weighted canvas is convolved with its wing kernel
(:func:`fftconvolve_multi`, float64 ``torch.fft``: cuFFT on the card), and
the sum, sampled at the exposure's pixels, is subtracted from every layer of
the cached cube.  The canvas lives on the caller's device; the host does the
WCS work and the FITS I/O.

Where the port holds its own course:

* the canvas points' sky positions, pixel areas and positions in each
  mosaic block (:class:`CanvasGeometry`) are computed once per exposure,
  not once per layer as the JAX package does; the values are the same
  (NumPy on the host, in chunks over a thread pool);
* there is no memory-mapped canvas (``use_memmap``): the canvas is a device
  tensor;
* there are no FFT worker counts (``fft_workers``, ``PYIMCOM_FFT_WORKERS``):
  the FFTs run on torch, and the port has no environment switches.

The Tukey windows, ``reinterp`` and ``bin_kernel_2x2`` are copies of the JAX
package's host code; keep them in step.

    python -m pyimcom_tpu_torch.splitpsf.imsubtract cfg.json <sca> [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..device import DTYPE, resolve_device
from ..ops.interp import interp2d_dense

# guard samples around a block for the G4460 resample
# (pyimcom_tpu/splitpsf/imsubtract.py:179-185)
BLOCK_PAD = 6
# canvas points a host thread transforms at a time
HOST_CHUNK = 1 << 20


def fftconvolve_multi(canvas: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """
    Valid-mode convolution of `canvas` (ny, nx) with a stack of `kernels`
    (nk, my, mx): returns (nk, ny-my+1, nx-mx+1), on the canvas's device.
    The canvas is transformed once; each kernel's spectrum is formed,
    multiplied into it and inverted in turn.  The transforms are circular
    on the canvas's own (ny, nx) grid, as the JAX package's are, so the
    valid window holds no wrapped samples.
    """
    ny, nx = canvas.shape
    nk, my, mx = kernels.shape
    oy, ox = ny - my + 1, nx - mx + 1
    if oy <= 0 or ox <= 0:
        raise ValueError("kernel larger than canvas")
    cf = torch.fft.rfft2(canvas, s=(ny, nx))
    out = torch.empty((nk, oy, ox), dtype=canvas.dtype, device=canvas.device)
    for k in range(nk):
        spec = torch.fft.rfft2(kernels[k], s=(ny, nx)).mul_(cf)
        out[k] = torch.fft.irfft2(spec, s=(ny, nx))[my - 1:my - 1 + oy, mx - 1:mx - 1 + ox]
        del spec
    return out


def tukey_window_1d(n: int, width: int) -> np.ndarray:
    """Flat-top window with cosine tapers of `width` samples on each side."""
    w = np.ones(n)
    if width > 0:
        t = 0.5 * (1 - np.cos(np.pi * np.arange(1, width + 1) / (width + 1)))
        w[:width] = t
        w[-width:] = t[::-1]
    return w


def tukey_window_2d(n: int, width: int) -> np.ndarray:
    w = tukey_window_1d(n, width)
    return np.outer(w, w)


def _put(a, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), dtype=DTYPE, device=device)


def _interp_scattered(image2d: torch.Tensor, qx: torch.Tensor, qy: torch.Tensor) -> torch.Tensor:
    """Interpolate one padded image at scattered points: the wing resample
    uses the 8x8 G4460 family (the reference's unconditional iG4460C call,
    imsubtract.py:652), K1 in its 8-tap form on the card."""
    return interp2d_dense(image2d[None], qx[None], qy[None], "G4460")[0]


def subtract_wings_from_exposure(exposure_image, exposure_wcs, mosaic_image,
                                 mosaic_wcs, K_cube, oversamp,
                                 eval_legendre_at=None, device="cuda"):
    """
    Subtract the long-range PSF contribution from one exposure.

    The (Gamma-smoothed) coadded mosaic is convolved with the exposure's
    wing kernel K (evaluated at the exposure center unless
    `eval_legendre_at` provides per-position Legendre weights) and the
    result is resampled onto the exposure grid (G4460) and subtracted.
    Returns the corrected exposure image (host NumPy).
    """
    dev = resolve_device(device)
    if eval_legendre_at is None:
        K = K_cube[0]
    else:
        K = np.einsum("a,aij->ij", eval_legendre_at, K_cube)

    conv = fftconvolve_multi(_put(mosaic_image, dev), _put(K[None], dev))[0]
    # mosaic pixel coordinates of the valid-convolution origin
    my, mx = K.shape
    off_y, off_x = (my - 1) / 2.0, (mx - 1) / 2.0

    ny, nx = exposure_image.shape
    yy, xx = np.mgrid[0:ny, 0:nx]
    ra, dec = exposure_wcs.pix2world(xx.ravel().astype(float), yy.ravel().astype(float))
    gx, gy = mosaic_wcs.world2pix(ra, dec)
    qx = gx - off_x + BLOCK_PAD
    qy = gy - off_y + BLOCK_PAD
    pad = torch.nn.functional.pad(conv, (BLOCK_PAD,) * 4)
    vals = _interp_scattered(pad, _put(qx, dev), _put(qy, dev)).cpu().numpy()
    return exposure_image - vals.reshape(ny, nx)


# --------------------------------------------------------------------------
# Blockwise stitched driver: walk the mosaic's blocks, Tukey-window each,
# resample onto an oversampled SCA canvas, convolve with the Legendre wing
# kernels, and subtract from the cached input cube
# (reference imsubtract.py:265-844).
# --------------------------------------------------------------------------


def _chunked(fn, *arrays):
    """fn over HOST_CHUNK-long pieces of the flat `arrays` on a thread pool
    (NumPy's elementwise work releases the GIL); the pieces of each of fn's
    outputs joined.  The values are those of fn on the whole arrays."""
    n = arrays[0].shape[0]
    starts = range(0, n, HOST_CHUNK)
    with ThreadPoolExecutor(max(1, min(len(starts), os.cpu_count() or 1))) as ex:
        parts = list(ex.map(lambda s: fn(*(a[s:s + HOST_CHUNK] for a in arrays)), starts))
    return tuple(np.concatenate(p) for p in zip(*parts))


class CanvasGeometry:
    """
    An exposure's oversampled canvas on the host: the sky position and the
    pixel solid angle (in ideal-output-pixel units) of every canvas point,
    and, per mosaic block, the points within the block's interpolation
    reach with their positions in the padded block.  Computed once per
    exposure and shared by its layers (the JAX package recomputes them per
    layer, with the same values); it holds no device memory, so one
    geometry serves any device.  Host memory: 24 bytes a canvas point, and
    20 (int32 index, f64 x and y) a point that a block reaches.
    """

    def __init__(self, exposure_wcs, x_canvas: np.ndarray):
        from ..config import Settings as Stn
        from ..wcsutil import get_pix_area

        self.A = len(x_canvas)
        gx, gy = (g.ravel() for g in np.meshgrid(x_canvas, x_canvas))  # gx along x
        self.ra, self.dec = _chunked(exposure_wcs.pix2world, gx, gy)
        (area,) = _chunked(lambda x, y: (get_pix_area(exposure_wcs, x, y),), gx, gy)
        self.area = area / Stn.pixscale_native ** 2
        self._blocks = {}

    def on_block(self, key, bwcs, N: int):
        """(flat canvas indices, x, y in the block padded by BLOCK_PAD) of
        the points that the (N, N) block `key` reaches, host arrays; None if
        there are none."""
        k = (key, N)
        if k not in self._blocks:
            xb, yb = _chunked(bwcs.world2pix, self.ra, self.dec)
            inside = (xb > -5.5) & (xb < N + 4.5) & (yb > -5.5) & (yb < N + 4.5)
            idx = np.flatnonzero(inside)
            if self.A * self.A < 2 ** 31:
                idx = idx.astype(np.int32)
            self._blocks[k] = None if idx.size == 0 else (
                idx, xb[idx] + BLOCK_PAD, yb[idx] + BLOCK_PAD)
        return self._blocks[k]


def build_wing_canvas(geometry: CanvasGeometry, block_reader, nblock: int, overlap: int,
                      layer: int, device) -> torch.Tensor:
    """
    Stitch the Tukey-windowed mosaic blocks of one layer onto the exposure's
    oversampled canvas (reference imsubtract.py:493-686): (A, A) float64 on
    `device`.

    block_reader(ix, iy) -> (data (n_out, nlayer, N, N) or (N, N), WCS) or
    None if the block does not exist.  Adjacent blocks overlap by
    2*`overlap` output pixels; the complementary cosine tapers sum to unity
    there, so the stitched mosaic is seamless.  Each resampled value is
    multiplied by the exposure pixel solid angle in ideal-output-pixel
    units (surface-brightness -> flux conversion).
    """
    A, dev = geometry.A, torch.device(device)
    H = torch.zeros(A * A, dtype=DTYPE, device=dev)
    for iy in range(nblock):
        for ix in range(nblock):
            got = block_reader(ix, iy)
            if got is None:
                continue
            data, bwcs = got
            data = np.asarray(data, dtype=np.float64)
            if data.ndim == 4:
                data = data[0, layer]
            N = data.shape[-1]
            pts = geometry.on_block((ix, iy), bwcs, N)
            if pts is None:
                continue
            idx, qx, qy = pts
            w = tukey_window_1d(N, 2 * overlap)
            pad = _put(np.pad(data * w[:, None] * w[None, :], BLOCK_PAD), dev)
            vals = _interp_scattered(pad, _put(qx, dev), _put(qy, dev))
            H.index_add_(0, torch.as_tensor(idx, device=dev), vals * _put(geometry.area[idx], dev))
    return H.reshape(A, A)


def wing_corrections(exposure_wcs, K_cube, oversamp: int, sca_nside: int, nblock: int,
                     overlap: int, block_reader, layers, porder: int = None,
                     device="cuda", geometry: CanvasGeometry = None):
    """
    Yield (layer, K (*) (stitched mosaic) sampled at the exposure's pixels:
    (sca_nside, sca_nside) float64 on `device`) for each of `layers`, the
    correction that :func:`subtract_wings_blockwise` subtracts.

    K_cube : (npoly, axis, axis) Legendre wing kernels on the `oversamp`
        grid, index lu + lv*Nl (reference imsubtract.py:523-529,689-708).
    geometry : the exposure's CanvasGeometry, if the caller has it already
        (made here otherwise).
    """
    dev = resolve_device(device)
    npoly, axis_num = K_cube.shape[0], K_cube.shape[-1]
    Nl = porder + 1 if porder is not None and porder >= 0 \
        else int(np.floor(np.sqrt(npoly + 0.5)))

    I_pad = int(np.ceil(axis_num / 2 / oversamp))
    first = (oversamp + 2 * oversamp * I_pad - axis_num) // 2
    A = oversamp * (sca_nside + 2 * I_pad)
    x_canvas = np.linspace(-I_pad - 0.5 + 0.5 / oversamp,
                           sca_nside + I_pad - 0.5 - 0.5 / oversamp, A)
    u_canvas = (x_canvas - (sca_nside - 1) / 2) / (sca_nside / 2)
    leg = np.polynomial.legendre.Legendre
    lvals = _put(np.stack([leg.basis(lv)(u_canvas) for lv in range(Nl)]), dev)
    kerns = _put(np.asarray(K_cube, dtype=np.float64), dev)
    if geometry is None:
        geometry = CanvasGeometry(exposure_wcs, x_canvas)

    for n in layers:
        H = build_wing_canvas(geometry, block_reader, nblock, overlap, n, dev)
        # each Legendre-weighted canvas is formed in turn (the JAX package
        # stacks all Nl**2 of them), in the same order of additions
        KH = torch.zeros((A - axis_num + 1, A - axis_num + 1), dtype=DTYPE, device=dev)
        for lv in range(Nl):
            for lu in range(Nl):
                a = H * lvals[lv][:, None] * lvals[lu][None, :]
                KH += fftconvolve_multi(a, kerns[lu + lv * Nl][None])[0]
                del a
        del H
        yield n, KH[first::oversamp, first::oversamp][:sca_nside, :sca_nside]
        del KH


def subtract_wings_blockwise(cube, exposure_wcs, K_cube, oversamp: int,
                             nblock: int, overlap: int, block_reader,
                             porder: int = None, max_layers: int = None,
                             device="cuda", geometry: CanvasGeometry = None):
    """
    Subtract K (*) (stitched mosaic) from every layer of one exposure cube
    (the first `max_layers` of them where given).

    cube : (nlayer, n, n) cached input cube (modified copy returned, host
        float32).
    The other arguments are those of :func:`wing_corrections`.
    """
    cube = np.array(cube, dtype=np.float32)
    nlayer, sca_nside = cube.shape[0], cube.shape[-1]
    nrun = nlayer if max_layers is None else min(nlayer, max_layers)
    for n, KH in wing_corrections(exposure_wcs, K_cube, oversamp, sca_nside, nblock, overlap,
                                  block_reader, range(nrun), porder, device, geometry):
        cube[n] -= KH.cpu().numpy()
    return cube


def _default_block_reader(outstem: str):
    """Read coadded block FITS files written by Block.build_output_file."""
    from ..fitsio import fits_read
    from ..wcsutil import WCS

    def reader(ix, iy):
        path = f"{outstem}_{ix:02d}_{iy:02d}.fits"
        if not os.path.exists(path):
            return None
        f = fits_read(path)
        return np.asarray(f[0].data), WCS.from_header(f[0].header)

    return reader


def reinterp(arr):
    """
    2x2 bin an oversampled kernel without growing the pixel tophat:
    interpolate arr[1:-1, 1:-1] onto a grid at double the spacing
    (reference imsubtract.py:241-262; the separable [-1/8, 9/8, 9/8, -1/8]
    filter is the cubic-interpolation midpoint stencil).
    """
    import scipy.signal

    _f = np.array([-0.125, 1.125, 1.125, -0.125], dtype=np.float64)
    f2d = np.outer(_f, _f)
    return scipy.signal.convolve(arr, f2d, mode="valid", method="direct")[::2, ::2]


def bin_kernel_2x2(K: np.ndarray, oversamp: int):
    """
    Downsample a Legendre wing-kernel cube to half the oversampling
    (reference imsubtract.py:360-384; PSFSPLIT[3] = bin2x2).  Returns
    (K_binned, oversamp // 2).
    """
    ncoeff, axis_num = K.shape[0], K.shape[1]
    if oversamp % 2:
        raise ValueError(f"oversamp={oversamp:d} is odd, not consistent with bin2x2")
    oversamp //= 2
    axis_num //= 2
    if oversamp % 2 and not (axis_num // oversamp) % 2:
        # trim 1 native pixel so axis_num / oversamp is odd
        axis_num -= oversamp
        K = K[:, oversamp - 1:1 - oversamp, oversamp - 1:1 - oversamp]
    else:
        K = np.pad(K, ((0, 0), (1, 1), (1, 1)), mode="edge")
    out = None
    for j in range(ncoeff):
        Ks = reinterp(K[j])
        if out is None:
            out = np.zeros((ncoeff,) + Ks.shape, dtype=np.float64)
        out[j] = Ks
    return out, oversamp


def wing_kernels(split_file: str, sca: int, oversamp: int = None, bin2x2: bool = False):
    """The wing-kernel cube of SCA `sca` (HDU KERSKIP + sca of the split
    file) and its oversampling, 2x2-binned where `bin2x2`."""
    from ..fitsio import fits_read

    sf = fits_read(split_file)
    kerskip = int(sf[0].header.get("KERSKIP", (len(sf) - 1) // 2))
    K_cube = np.asarray(sf[kerskip + sca].data, dtype=np.float64)
    if oversamp is None:
        oversamp = int(sf[0].header.get("OVSAMP", 1))
    if bin2x2:
        # halve the kernel oversampling: 4x fewer canvas samples and ~4x
        # cheaper convolutions at slightly reduced wing resolution
        K_cube, oversamp = bin_kernel_2x2(K_cube, oversamp)
    return K_cube, oversamp


def run_imsubtract(cfg, idsca, split_file: str, out_file: str = None,
                   oversamp: int = None, max_layers: int = None,
                   bin2x2: bool = None, device="cuda") -> str:
    """
    Wing-subtract one cached exposure and write `*_subI.fits`
    (reference imsubtract.py:265-729).

    split_file : split-PSF FITS from splitpsf.split_psf_to_fits; the wing
        kernel for SCA s is HDU[KERSKIP + s].
    """
    from ..fitsio import HDUList, ImageHDU, fits_read, fits_write

    obsid, sca = idsca
    cache = cfg.inlayercache + f"_{obsid:08d}_{sca:02d}.fits"
    f = fits_read(cache)
    cube = np.asarray(f[0].data, dtype=np.float32)
    if cube.ndim == 2:
        cube = cube[None]
    wcs_ = get_cache_wcs(f)

    if bin2x2 is None:
        bin2x2 = bool(getattr(cfg, "psfsplit_bin2x2", False))
    K_cube, oversamp = wing_kernels(split_file, sca, oversamp, bin2x2)

    overlap = cfg.n2 * cfg.postage_pad
    reader = _default_block_reader(cfg.outstem)
    out = subtract_wings_blockwise(cube, wcs_, K_cube, oversamp, cfg.nblock,
                                   overlap, reader, max_layers=max_layers,
                                   device=device)

    if out_file is None:
        out_file = cfg.inlayercache + f"_{obsid:08d}_{sca:02d}_subI.fits"
    hdu = ImageHDU(out.astype(np.float32))
    hdu.header = f[0].header
    # carry the SCIWCS HDU forward so update_cube's swap keeps the cache
    # self-describing for the next wing-subtraction iteration
    extra = [h for h in list(f)[1:] if h.name == "SCIWCS"]
    fits_write(out_file, HDUList([hdu] + extra))
    return out_file


def get_cache_wcs(hdus):
    """
    WCS of a cached input-layer file (reference imsubtract.py:190-216
    ``get_wcs``): prefer the SCIWCS HDU written by the layer stage —
    FITS-style cards, or a WCSSRC pointer back to the exposure's ASDF
    file for GWCS — falling back to the primary header for legacy caches.
    """
    from ..wcsutil import WCS

    try:
        sw = hdus["SCIWCS"]
    except KeyError:
        sw = None
    if sw is not None:
        wcstype = str(sw.header.get("WCSTYPE", "FITS")).strip().upper()
        if wcstype.startswith("GWCS"):
            from ..asdfio import GWCS, asdf_read

            tree = asdf_read(str(sw.header["WCSSRC"]).strip())
            return GWCS(tree["roman"]["meta"]["wcs"])
        return WCS.from_header(sw.header)
    return WCS.from_header(hdus[0].header)


def run_imsubtract_all(cfg, idscas, split_file: str, nworkers: int = None,
                       **kw) -> list:
    """
    Wing-subtract every exposure of a mosaic (reference
    imsubtract_wrapper.py:12-106).  Work items are independent; with
    nworkers > 1 they run in a forkserver process pool (each process on
    the device of `kw`), otherwise serially in-process.
    """
    if nworkers and nworkers > 1:
        import concurrent.futures as cf
        import multiprocessing as mp

        ctx = mp.get_context("forkserver")
        with cf.ProcessPoolExecutor(max_workers=nworkers,
                                    mp_context=ctx) as ex:
            futs = [ex.submit(run_imsubtract, cfg, idsca, split_file, **kw)
                    for idsca in idscas]
            return [fu.result() for fu in futs]
    return [run_imsubtract(cfg, idsca, split_file, **kw) for idsca in idscas]


def main(cfgfile, sca: int, device="cuda"):
    """
    Wing-subtract every cached exposure using the given SCA (reference
    job-array entry ``python -m pyimcom.splitpsf.imsubtract cfg sca``,
    imsubtract.py:265 / imsubtract_wrapper.py:12).

    The split-PSF file for observation `obsid` is
    INLAYERCACHE.psf/psf_{obsid}.fits (written by splitpsf.main); exposures
    are discovered from the input-layer cache.
    """
    import glob
    import re

    from ..config import Config

    cfg = cfgfile if hasattr(cfgfile, "inlayercache") else Config(cfgfile)
    pat = re.compile(r"_(\d{8})_(\d{2})\.fits$")
    idscas = []
    for path in sorted(glob.glob(cfg.inlayercache + "_*_*.fits")):
        mm = pat.search(path)
        if mm and int(mm.group(2)) == sca:
            idscas.append((int(mm.group(1)), sca))
    done = []
    for idsca in idscas:
        split_file = cfg.inlayercache + f".psf/psf_{idsca[0]:d}.fits"
        if not os.path.exists(split_file):
            print(f"imsubtract: no split PSF for obsid {idsca[0]}, skipping",
                  flush=True)
            continue
        done.append(run_imsubtract(cfg, idsca, split_file, device=device))
        print("imsubtract: wrote", done[-1], flush=True)
    return done


def _cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description="wing subtraction of one SCA's cached "
                                             "exposures (a job-array task)")
    ap.add_argument("config", help="JSON configuration file")
    ap.add_argument("sca", type=int, help="SCA number")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    main(args.config, args.sca, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(_cli())
