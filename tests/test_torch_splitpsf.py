"""The split-PSF loop of pyimcom_tpu_torch against the JAX package's.

* Twins of tests/test_splitpsf.py: the decomposition, the split file (bit for
  bit the JAX package's), the cache update and the 2x2 kernel binning.
  The port has no FFT worker count, so ``test_fft_workers_env`` has no twin.
* Twins of tests/test_imsubtract_driver.py, and the wing subtraction against
  the JAX functions on a small synthetic geometry (a 48x48 exposure under a
  2x2 mosaic of blocks, the split kernel of the survey fixture's PSF, with
  and without bin2x2): the cube within 2 float32 spacings at max|cube| (the
  cube is float32 and takes an f64 subtraction), ``fftconvolve_multi`` to
  1e-12 of max|out|.
* The update and iteration 1: both packages' ``update_cube`` on the same
  synthetic ``_subI`` files give the same cache, iteration counter and
  history, and the iteration-1 block matches the reference Block at STOP 2
  (compare_outputs_f32) with equal OLDCFG HDUs.

Everything runs on the CPU, where the port's K1 in its G4460 form runs its
plain version.
"""

import json
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import scipy.signal
import torch

from pyimcom_tpu.splitpsf import imsubtract as ref_imsub
from pyimcom_tpu.splitpsf import splitpsf as ref_split
from pyimcom_tpu.splitpsf.update_cube import update as ref_update
from pyimcom_tpu_torch.ops import interp_cuda
from pyimcom_tpu_torch.splitpsf import imsubtract, splitpsf
from pyimcom_tpu_torch.splitpsf.update_cube import get_iteration, update
from test_torch_block import (_cfg, compare_outputs_f32, same_oldcfg, small_survey,  # noqa: F401
                              split_psfs)

torch.set_num_threads(1)


def _airy_cube(n=96, npoly=4):
    from pyimcom_tpu_torch.ops.psfmodels import psf_cplx_airy

    cube = np.zeros((npoly, n, n))
    cube[0] = psf_cplx_airy(n, 6 * 1.326, sigma=6 * 0.2)
    if npoly > 1:
        cube[1] = 0.03 * np.roll(cube[0], 2, axis=0)  # weak spatial variation
    return cube


def _within_2_spacings(got, want):
    """Float32 cubes within 2 float32 spacings at max|want|."""
    tol = 2 * np.spacing(np.float32(np.abs(want).max()))
    assert got.dtype == want.dtype == np.float32
    assert float(np.abs(got.astype(np.float64) - want).max()) <= tol


# --------------------------------------------------------------------------
# twins of tests/test_splitpsf.py
# --------------------------------------------------------------------------

def test_window_limits():
    w = splitpsf.SplitPSF.window_integrated_blackman(np.array([-2.0, -1.0, 0.0, 1.0, 2.0]))
    np.testing.assert_allclose(w, [0, 0, 0.5, 1, 1], atol=1e-12)
    x = np.linspace(-1, 1, 201)
    assert np.all(np.diff(splitpsf.SplitPSF.window_integrated_blackman(x)) >= -1e-12)


def test_decomposition_identity():
    """G (tophat-filtered) == G^S + K (*) Gamma + zeta at the Legendre nodes,
    and every array of the port's split is the JAX package's, bit for bit."""
    from scipy.special import eval_legendre, roots_legendre

    cube = _airy_cube()
    pars = {"oversamp": 6, "r_in": 3.0, "r_out": 7.0, "sigmaGamma": 1.0,
            "eps": 0.02, "tophat_in": True}
    sp = splitpsf.SplitPSF(cube, None, pars)
    sp.build()
    rf = ref_split.SplitPSF(cube, None, pars)
    rf.build()
    for name in ("smallpsf", "K_Legendre", "K_real", "zeta_real", "Cov"):
        np.testing.assert_array_equal(getattr(sp, name), getattr(rf, name))
    n = cube.shape[1]
    xL, _ = roots_legendre(sp.lorder + 1)
    xg, yg = (a.ravel() for a in np.meshgrid(xL, xL))
    for i in [0, sp.npoly - 1]:
        lr = np.arange(sp.lorder + 1)
        lpw = np.outer(eval_legendre(lr, yg[i]), eval_legendre(lr, xg[i])).ravel()
        G = np.einsum("a,aij->ij", lpw, sp.psfcube)
        GS_full = np.einsum("a,aij->ij", lpw,
                            sp.psfcube * splitpsf.SplitPSF.window_2d(n, 18, 42)[None])
        recon = (GS_full + scipy.signal.convolve(
            sp.K_real[i], splitpsf.SplitPSF.gauss_stamp(n, sp.Cov[i]), mode="same",
            method="fft") + sp.zeta_real[i])
        np.testing.assert_allclose(recon, G, atol=1e-10 * np.abs(G).max() + 1e-12)
        assert np.linalg.norm(sp.zeta_real[i]) < 0.5 * np.linalg.norm(G - GS_full) + 1e-12


@pytest.mark.parametrize("savezeta", [False, True], ids=["plain", "savezeta"])
def test_split_psf_to_fits_layout_and_bytes(tmp_path, savezeta):
    """The reference layout (originals, short-range, kernels, zetas), and
    the port's file is the JAX package's byte for byte."""
    from pyimcom_tpu_torch.fitsio import HDUList, ImageHDU, fits_read, fits_write

    cube = _airy_cube(n=64, npoly=1).astype(np.float32)
    fits_write(tmp_path / "psf_in.fits",
               HDUList([ImageHDU(None)] + [ImageHDU(cube) for _ in range(3)]))
    pars = {"oversamp": 6, "tophat_in": True, "SAVEZETA": savezeta}
    out = splitpsf.split_psf_to_fits(str(tmp_path / "psf_in.fits"), None, pars,
                                     str(tmp_path / "port.fits"))
    ref_split.split_psf_to_fits(str(tmp_path / "psf_in.fits"), None, pars,
                                str(tmp_path / "ref.fits"))
    assert (tmp_path / "port.fits").read_bytes() == (tmp_path / "ref.fits").read_bytes()
    f = fits_read(out)
    assert f[0].header["GSSKIP"] == 3 and f[0].header["KERSKIP"] == 6
    assert len(f) == (13 if savezeta else 10)
    np.testing.assert_allclose(f[1].data, cube, atol=1e-7)
    assert f[4].header["IMTYPE"].strip() == "Short range PSF"
    assert f[7].header["IMTYPE"].strip() == "Kernel K"
    assert "MAXZETA" in f[7].header and "KINT" in f[7].header
    assert f[0].header["MAXZETA"] >= 0
    if savezeta:
        assert f[0].header["ZETASKIP"] == 9 and f[10].data.shape == cube.shape


def test_splitpsf_main_matches_reference(small_survey, tmp_path):  # noqa: F811
    """splitpsf.main on the survey (every in-filter observation, the SCAs
    with an image file carrying their WCS): the same split files, byte for
    byte."""
    from pyimcom_tpu.config import Config as RefConfig
    from pyimcom_tpu_torch.config import Config

    d = dict(small_survey, PSFSPLIT=[3.0, 6.0, 0.01])
    counts = {}
    for name, main, cfg_cls in (("ref", ref_split.main, RefConfig),
                                ("port", splitpsf.main, Config)):
        counts[name] = main(cfg_cls(dict(d, INLAYERCACHE=str(tmp_path / name / "in"))))
    assert counts["port"] == counts["ref"] >= 4
    names = sorted(os.listdir(tmp_path / "ref" / "in.psf"))
    assert names == sorted(os.listdir(tmp_path / "port" / "in.psf")) and names
    for nm in names:
        assert (tmp_path / "ref" / "in.psf" / nm).read_bytes() == \
            (tmp_path / "port" / "in.psf" / nm).read_bytes(), nm


def test_fftconvolve_multi_matches_scipy_and_reference():
    rng = np.random.default_rng(0)
    canvas = rng.normal(size=(64, 72))
    kernels = rng.normal(size=(3, 9, 11))
    out = imsubtract.fftconvolve_multi(torch.as_tensor(canvas), torch.as_tensor(kernels))
    out = out.numpy()
    scale = np.abs(out).max()
    for k in range(3):
        want = scipy.signal.convolve(canvas, kernels[k], mode="valid")
        np.testing.assert_allclose(out[k], want, rtol=0, atol=1e-12 * scale)
    for use_jax in (False, True):
        np.testing.assert_allclose(
            out, ref_imsub.fftconvolve_multi(canvas, kernels, use_jax=use_jax),
            rtol=0, atol=1e-12 * scale)
    with pytest.raises(ValueError, match="larger"):
        imsubtract.fftconvolve_multi(torch.as_tensor(canvas[:5]), torch.as_tensor(kernels))


def _update_cfg(cache):
    from pyimcom_tpu_torch.config import Config

    return Config({"OBSFILE": "x", "INDATA": ["x", "L2_fits"], "CTR": [0, 0],
                   "OUTSIZE": [4, 8, 0.04], "BLOCK": 1, "FILTER": 1,
                   "INPSF": ["x", "L2_fits", 6], "OUT": "x", "INLAYERCACHE": cache})


def test_update_cube(tmp_path):
    cache = str(tmp_path / "cache" / "in")
    os.makedirs(tmp_path / "cache")
    for obsid in [3, 7]:
        with open(f"{cache}_{obsid:08d}_01.fits", "w") as f:
            f.write("old")
        with open(f"{cache}_{obsid:08d}_01_subI.fits", "w") as f:
            f.write("new")
    cfg = _update_cfg(cache)
    assert get_iteration(cache) == 0
    assert update(cfg) == 1 and get_iteration(cache) == 1
    with open(f"{cache}_{3:08d}_01.fits") as f:
        assert f.read() == "new"
    with open(str(tmp_path / "cache" / "in.iter0" / "in_00000003_01.fits")) as f:
        assert f.read() == "old"
    assert update(cfg) == 2
    with open(cache + "_oldcfg.json") as f:
        assert len(json.load(f)) == 2


def test_reinterp_and_bin2x2():
    """The port's 2x2 binning is the JAX package's, bit for bit, and keeps
    its properties (reference imsubtract.py:241-262, 360-384)."""
    y, x = np.mgrid[0:18, 0:18].astype(np.float64)
    lin = 2.0 + 0.3 * x - 0.1 * y
    out = imsubtract.reinterp(lin)
    np.testing.assert_array_equal(out, ref_imsub.reinterp(lin))
    i, j = np.mgrid[0:8, 0:8].astype(np.float64)
    np.testing.assert_allclose(out, 4.0 * (2.0 + 0.3 * (2 * j + 1.5) - 0.1 * (2 * i + 1.5)),
                               atol=1e-10)
    ov, n = 6, 48
    yy, xx = np.mgrid[0:n, 0:n]
    c = (n - 1) / 2
    K = np.exp(-0.5 * ((xx - c) ** 2 + (yy - c) ** 2) / (1.5 * ov) ** 2)
    K = np.stack([K, 0.1 * K])
    Kb, ov2 = imsubtract.bin_kernel_2x2(K, ov)
    Kr, ovr = ref_imsub.bin_kernel_2x2(K, ov)
    np.testing.assert_array_equal(Kb, Kr)
    assert ov2 == ovr == ov // 2
    assert abs(Kb[0].sum() / K[0].sum() - 1) < 0.03
    np.testing.assert_allclose(Kb[1], 0.1 * Kb[0], atol=1e-12)
    with pytest.raises(ValueError):
        imsubtract.bin_kernel_2x2(K, 5)


# --------------------------------------------------------------------------
# twins of tests/test_imsubtract_driver.py
# --------------------------------------------------------------------------

def test_tukey_partition_of_unity():
    N, overlap = 30, 5
    w = imsubtract.tukey_window_1d(N, 2 * overlap)
    np.testing.assert_allclose(w[N - 2 * overlap:] + w[:2 * overlap], 1.0, atol=1e-12)
    for n, width in ((30, 10), (17, 0), (9, 4)):
        np.testing.assert_array_equal(imsubtract.tukey_window_2d(n, width),
                                      ref_imsub.tukey_window_2d(n, width))


def _mosaic(nside_exp, Nside, n2, pad, pixscale=0.04):
    """A 2x2 mosaic of blocks of Nside + 2 n2 pad pixels of `pixscale`
    arcsec about the centre of a native-scale, slightly rotated STG
    exposure of nside_exp pixels: (cfg, {(ix, iy): block WCS}, exposure
    WCS)."""
    from pyimcom_tpu_torch.wcsutil import WCS, make_block_wcs

    cfg = SimpleNamespace(n2=n2, postage_pad=pad, nblock=2, Nside=Nside,
                          NsideP=Nside + 2 * n2 * pad, ra=10.0, dec=-5.0,
                          dtheta=pixscale / 3600.0, lonpole=180.0)
    bwcs = {(ix, iy): make_block_wcs(cfg, ix, iy) for ix in range(2) for iy in range(2)}
    s = 0.11 / 3600.0
    c = (nside_exp - 1) / 2
    ewcs = WCS(ctype=("RA---STG", "DEC--STG"), crval=(cfg.ra, cfg.dec), crpix=(c, c),
               cd=np.array([[-s * 0.996, 0.087 * s], [0.087 * s, s * 0.996]]),
               lonpole=180.0)
    return cfg, bwcs, ewcs


def test_blockwise_subtraction_constant_mosaic():
    """A constant mosaic stitched from 2x2 overlapping blocks and a delta
    wing kernel: the subtraction removes exactly that constant."""
    from pyimcom_tpu_torch.wcsutil import WCS

    cfg, bwcs, _ = _mosaic(20, 20, 5, 1, pixscale=0.11)

    s = 0.11 / 3600.0
    ewcs = WCS(ctype=("RA---STG", "DEC--STG"), crval=(cfg.ra, cfg.dec),
               crpix=(9.5, 9.5), cd=np.diag([-s, s]), lonpole=180.0)
    K = np.zeros((1, 5, 5))
    K[0, 2, 2] = 1.0
    interp_cuda.reset_launch_counts()
    out = imsubtract.subtract_wings_blockwise(
        np.zeros((1, 20, 20), dtype=np.float32), ewcs, K, oversamp=1, nblock=2,
        overlap=cfg.n2 * cfg.postage_pad,
        block_reader=lambda ix, iy: (np.ones((cfg.NsideP, cfg.NsideP)), bwcs[(ix, iy)]),
        device="cpu")
    assert interp_cuda.launches["interp_g4460_dense"] == 0          # CPU: plain
    np.testing.assert_allclose(out[0], -1.0, atol=1e-3)


@pytest.fixture(scope="module")
def wing_kernel():
    """The Legendre wing kernels of the survey fixture's PSF (120^2 at
    oversampling 6, 4 Legendre terms), split as splitpsf.main splits it
    for PSFSPLIT [3.0, 6.0, 0.01] (EXTRASMOOTH 0.9265)."""
    from pyimcom_tpu_torch.ops.psfmodels import psf_cplx_airy

    cube = np.zeros((4, 120, 120))
    cube[0] = psf_cplx_airy(120, 6 * 1.326, sigma=6 * 0.3, features=3)
    cube[1] = 0.05 * np.roll(cube[0], 3, axis=1)
    sp = splitpsf.SplitPSF(cube.astype(np.float32).astype(np.float64), None,
                           {"smallstamp_size": 80, "sigmaGamma": 0.9265328730414752,
                            "r_in": 3.0, "r_out": 6.0, "eps": 0.01, "oversamp": 6})
    sp.build()
    return sp.K_Legendre.astype(np.float32).astype(np.float64)


def blockwise_against_reference(K, ov):
    """subtract_wings_blockwise of both packages with the wing kernels `K`
    at oversampling `ov` on a 48x48 two-layer cube under a 2x2 mosaic of
    smooth random blocks (four-dimensional block data, layers read by
    index), the port on the CPU: asserts that the wings were removed and
    that the port is within 2 float32 spacings at max|cube| of the JAX
    driver."""
    cfg, bwcs, ewcs = _mosaic(48, 80, 5, 1)
    rng = np.random.default_rng(31)
    N = cfg.NsideP
    yy, xx = np.mgrid[0:N, 0:N]
    blocks = {}
    for key in bwcs:
        data = np.zeros((1, 2, N, N))
        for layer in range(2):
            for _ in range(4):
                x0, y0, s = rng.uniform(0, N), rng.uniform(0, N), rng.uniform(3, 9)
                data[0, layer] += rng.uniform(1, 50) * np.exp(
                    -0.5 * ((xx - x0) ** 2 + (yy - y0) ** 2) / s ** 2)
        blocks[key] = data

    def reader(ix, iy):
        return blocks[(ix, iy)], bwcs[(ix, iy)]

    cube = rng.normal(scale=20.0, size=(2, 48, 48)).astype(np.float32)
    overlap = cfg.n2 * cfg.postage_pad
    want = ref_imsub.subtract_wings_blockwise(cube, ewcs, K, ov, 2, overlap, reader)
    got = imsubtract.subtract_wings_blockwise(cube, ewcs, K, ov, 2, overlap, reader,
                                              device="cpu")
    assert np.abs(want - cube).max() > 1e-3 * np.abs(cube).max()   # wings removed
    _within_2_spacings(got, want)


@pytest.mark.parametrize("bin2x2", [False, True], ids=["ov6", "bin2x2"])
def test_subtract_wings_blockwise_matches_reference(wing_kernel, bin2x2):
    """blockwise_against_reference with the survey PSF's wing kernels at
    oversampling 6, and 2x2-binned to 3."""
    K, ov = wing_kernel, 6
    if bin2x2:
        K, ov = imsubtract.bin_kernel_2x2(K, ov)
    blockwise_against_reference(K, ov)


def test_subtract_wings_from_exposure_matches_reference(wing_kernel):
    """The single-canvas core: a smooth random mosaic of 250^2 pixels (the
    valid convolution with the 120^2 kernel covers most of the exposure),
    at the exposure centre and with Legendre weights."""
    cfg, bwcs, ewcs = _mosaic(48, 240, 5, 1)
    rng = np.random.default_rng(7)
    mosaic = scipy.signal.convolve(rng.normal(size=(cfg.NsideP, cfg.NsideP)),
                                   np.ones((5, 5)) / 25, mode="same")
    image = rng.normal(size=(48, 48))
    weights = np.array([1.0, 0.2, -0.1, 0.05])
    for ev in (None, weights):
        want = ref_imsub.subtract_wings_from_exposure(
            image, ewcs, mosaic, bwcs[(0, 0)], wing_kernel, 6, eval_legendre_at=ev)
        got = imsubtract.subtract_wings_from_exposure(
            image, ewcs, mosaic, bwcs[(0, 0)], wing_kernel, 6, eval_legendre_at=ev,
            device="cpu")
        assert np.abs(want - image).max() > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


# --------------------------------------------------------------------------
# the update and iteration 1
# --------------------------------------------------------------------------

def _synthetic_subI(cache):
    """A `_subI` file beside each cached cube: the cube less 1 % of itself
    and a smooth ramp, with the cache file's header and SCIWCS HDU."""
    import glob

    from pyimcom_tpu_torch.fitsio import HDUList, ImageHDU, fits_read, fits_write

    made = 0
    for path in sorted(glob.glob(cache + "_*_*.fits")):
        if path.endswith("_subI.fits"):
            continue
        f = fits_read(path)
        cube = np.asarray(f[0].data, dtype=np.float32)
        ramp = np.linspace(0.0, 1e-3, cube.shape[-1], dtype=np.float32)
        hdu = ImageHDU((0.99 * cube - ramp[None, None, :]).astype(np.float32))
        hdu.header = f[0].header
        fits_write(path[:-5] + "_subI.fits",
                   HDUList([hdu] + [h for h in list(f)[1:] if h.name == "SCIWCS"]))
        made += 1
    return made


def _copy_layer_cache(shared, private):
    """Copy the shared survey's cached layer cubes (each under the cache's
    own file lock) into a private cache, where update_cube may swap them."""
    import glob

    from filelock import FileLock

    for path in sorted(glob.glob(shared + "_*_*.fits")):
        with FileLock(path + ".lock"):
            shutil.copy(path, private + path[len(shared):])


def test_update_and_iteration_1_match_reference(small_survey, monkeypatch, tmp_path):  # noqa: F811
    """Iteration 0 with the port on the shared survey's cache (its split
    files and layer cubes, OLDCFG 0); then, in a private copy of that
    cache, the same synthetic `_subI` files swapped in by each package's
    update_cube, and the iteration-1 block of each: equal caches, counters
    and histories; the port's block matches the reference Block at STOP 2
    with equal OLDCFG (IMSBITER 1)."""
    from pyimcom_tpu.coadd import Block as RefBlock
    from pyimcom_tpu.config import Config as RefConfig
    from pyimcom_tpu_torch.coadd import Block
    from pyimcom_tpu_torch.config import Config
    from pyimcom_tpu_torch.fitsio import fits_read

    monkeypatch.setenv("PYIMCOM_DEVICE_ASSEMBLY", "1")
    monkeypatch.setenv("PYIMCOM_NDEVICES", "1")
    shared = dict(small_survey, PSFSPLIT=[6.0, 7.0, 1e-3], OUT=str(tmp_path / "out"))
    split_psfs(shared)
    cfg0, out0 = _cfg(shared, "_it0", stop=2)
    Block(cfg=cfg0, this_sub=1, device="cpu")
    assert fits_read(out0)["OLDCFG"].header["IMSBITER"] == 0
    cache = str(tmp_path / "cache" / "in")
    d = dict(shared, INLAYERCACHE=cache)
    os.makedirs(tmp_path / "cache")
    _copy_layer_cache(shared["INLAYERCACHE"], cache)
    shutil.copytree(shared["INLAYERCACHE"] + ".psf", cache + ".psf")
    assert _synthetic_subI(cache) >= 1
    snapshot = tmp_path / "snapshot"
    shutil.copytree(tmp_path / "cache", snapshot)

    def state():
        it = open(cache + "_iter.txt").read()
        hist = json.loads(open(cache + "_oldcfg.json").read())
        files = {p: (tmp_path / "cache" / p).read_bytes()
                 for p in sorted(os.listdir(tmp_path / "cache"))
                 if p.endswith(".fits")}
        arch = sorted(os.listdir(cache + ".iter0"))
        return it, hist, files, arch

    assert ref_update(RefConfig(dict(d))) == 1
    ref_state = state()
    cfg1, out_ref = _cfg(d, "_it1_ref", stop=2)
    RefBlock(cfg=cfg1, this_sub=1)

    shutil.rmtree(tmp_path / "cache")
    shutil.copytree(snapshot, tmp_path / "cache")
    assert update(Config(dict(d))) == 1
    assert state() == ref_state
    assert ref_state[1][0]["iteration"] == 0
    cfg1, out_port = _cfg(d, "_it1_port", stop=2)
    Block(cfg=cfg1, this_sub=1, device="cpu")
    compare_outputs_f32(out_ref, out_port)
    assert same_oldcfg(out_ref, out_port) == 1
