"""Metadetection in the port, pyimcom_tpu_torch.meta, against the JAX
package's pyimcom_tpu.meta on the CPU.

Twins of the five tests of tests/test_meta.py run through both packages:
InterpMatrix is a host copy and must match bit for bit; MultiInterp on the
CPU route (``device="cpu"``: its tap gather as torch gathers) must match
within one float32 spacing of max|out|, with out_mask, Umax and Smax equal
(it keeps the JAX package's dtype and order of accumulation, so it matches
exactly here).  The same on a 2-layer float32 mosaic with a mask under a
sheared, magnified map.  MetaMosaic and shearimage are held to the JAX
MetaMosaic on a 3x3 set of block files in the coadd's layout (the CONFIG
HDU, FIDELITY and SIGMA maps, a PAD of one stamp) made from seeded data:
the mosaic, fidelity, noise and masks equal, the sheared image within 2
float32 spacings of its maximum.
"""

import numpy as np
import pytest
import torch

from pyimcom_tpu.meta import distortimage as ref_dist
from pyimcom_tpu.meta import ginterp as ref
from pyimcom_tpu_torch.meta import distortimage, ginterp

torch.set_num_threads(1)
CPU = "cpu"
# a 3x3 mosaic of blocks of 2 x 2 stamps of 20 pixels with a PAD of one
# stamp, two layers, the Gaussian target PSF
BLOCKS = dict(BLOCK=3, OUTSIZE=[2, 20, 0.04], PAD=1, EXTRAINPUT=["cstar14"],
              OUTPSF="GAUSSIAN")


def _both(*args, **kw):
    """MultiInterp of both packages on the same inputs: (port, reference)."""
    return ginterp.MultiInterp(*args, device=CPU, **kw), ref.MultiInterp(*args, **kw)


def _same_interp(got, want, spacings=1):
    out, mask, Umax, Smax = got
    assert out.dtype == want[0].dtype and out.shape == want[0].shape
    scale = np.abs(want[0]).max()
    bound = spacings * np.spacing(np.float32(scale))
    assert np.abs(out.astype(np.float64) - want[0]).max() <= bound
    assert np.array_equal(mask, want[1])
    assert Umax == want[2] and Smax == want[3]
    return out, mask, Umax, Smax


def test_interp_matrix_quality():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, 64)
    y = rng.uniform(0, 1, 64)
    got = ginterp.InterpMatrix(6.0, 4.0, x, y, [0.0, 0.0, 0.0])
    want = ref.InterpMatrix(6.0, 4.0, x, y, [0.0, 0.0, 0.0])
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    posx, posy, T, U, S = got
    assert T.shape == (64, posx.size)
    np.testing.assert_allclose(T.sum(axis=1), 1.0, atol=1e-10)
    assert np.max(U) < 1e-5
    assert np.max(S) < 1.0


def test_interp_matrix_smoothing_widens_psf():
    sigma_pix = 4.0 / np.sqrt(8 * np.log(2))
    n = 64
    yy, xx = np.mgrid[0:n, 0:n].astype(float)
    img = np.exp(-((xx - 31.0) ** 2 + (yy - 31.0) ** 2) / (2 * sigma_pix ** 2))
    Cxx = Cyy = 3.0
    got, want = _both(img, np.zeros_like(img, dtype=bool), (n, n), np.array([0.0, 0.0]),
                      np.identity(2), 6.0, 4.0, [Cxx, 0.0, Cyy])
    out, _mask, Umax, _Smax = _same_interp(got, want)
    tot = out.sum()
    cx = (out * xx).sum() / tot
    vxx = (out * (xx - cx) ** 2).sum() / tot
    assert abs(vxx - (sigma_pix ** 2 + Cxx)) / (sigma_pix ** 2 + Cxx) < 0.02
    assert Umax < 1e-4


def test_multiinterp_identity_resample():
    n = 48
    yy, xx = np.mgrid[0:n, 0:n].astype(float)
    img = np.sin(xx / 7.0) + np.cos(yy / 9.0)
    got, want = _both(img, np.zeros_like(img, dtype=bool), (n, n), np.array([0.0, 0.0]),
                      np.identity(2), 6.0, 4.0, [0.0, 0.0, 0.0])
    out, mask, _U, _S = _same_interp(got, want)
    good = ~mask
    assert good.sum() > 0.5 * n * n
    np.testing.assert_allclose(out[good], img[good], atol=2e-3)


def test_multiinterp_shift():
    n = 48
    yy, xx = np.mgrid[0:n, 0:n].astype(float)
    img = np.exp(-((xx - 24.0) ** 2 + (yy - 24.0) ** 2) / (2 * 3.0 ** 2))
    got, want = _both(img, np.zeros_like(img, dtype=bool), (n, n), np.array([0.5, 0.25]),
                      np.identity(2), 6.0, 4.0, [0.0, 0.0, 0.0])
    out, mask, _U, _S = _same_interp(got, want)
    tot = out[~mask].sum()
    assert abs((out * xx)[~mask].sum() / tot - 23.5) < 0.02
    assert abs((out * yy)[~mask].sum() / tot - 23.75) < 0.02


def test_multiinterp_mask_propagates():
    n = 48
    img = np.ones((n, n))
    inmask = np.zeros((n, n), dtype=bool)
    inmask[20:24, 20:24] = True
    got, want = _both(img, inmask, (n, n), np.array([0.0, 0.0]), np.identity(2),
                      4.0, 4.0, [0.0, 0.0, 0.0])
    out, mask, _U, _S = _same_interp(got, want)
    assert mask[21, 21]
    assert np.all(out[mask] == 0.0)


@pytest.mark.parametrize("blocksize", [393216, 700], ids=["one-block", "blocks"])
def test_multiinterp_two_float32_layers_with_a_mask(blocksize):
    """A 2-layer float32 mosaic (a smooth field and seeded noise), a masked
    patch, a sheared and magnified map with extra smoothing, one block of
    output pixels or several."""
    rng = np.random.default_rng(7)
    n = 56
    yy, xx = np.mgrid[0:n, 0:n].astype(float)
    img = np.stack([np.sin(xx / 5.0) * np.cos(yy / 6.0),
                    rng.standard_normal((n, n))]).astype(np.float32)
    inmask = rng.uniform(size=(n, n)) < 0.01
    inmask[30:33, 10:14] = True
    J = np.array([[1.03, 0.02], [-0.015, 0.97]])
    got, want = _both(img, inmask, (44, 44), np.array([3.3, 2.1]), J, 6.0, 4.0,
                      [0.5, 0.1, 0.4], blocksize=blocksize)
    out, mask, _U, _S = _same_interp(got, want)
    assert out.dtype == np.float32 and mask.any() and not mask.all()


def test_multiinterp_too_large_search_box_stops():
    """The JAX package's early break: a search box wider than the mosaic
    leaves every output pixel masked and zero."""
    img = np.ones((8, 8), dtype=np.float32)
    got, want = _both(img, np.zeros((8, 8), dtype=bool), (6, 6), np.array([1.0, 1.0]),
                      np.identity(2), 6.0, 4.0, [0.0, 0.0, 0.0])
    out, mask, Umax, Smax = _same_interp(got, want)
    assert mask.all() and not out.any() and Umax == Smax == 0.0


def write_blocks(root, seed=0):
    """A 3x3 mosaic of block files in the coadd's layout (science cube
    (1, nlayer, NsideP, NsideP) float32, CONFIG, FIDELITY and SIGMA as the
    Block writes them), from seeded data; returns the central file."""
    from survey_fixture_torch import CONFIG_TEMPLATE
    from pyimcom_tpu_torch.config import Config
    from pyimcom_tpu_torch.fitsio import HDUList, ImageHDU, TableHDU, fits_write
    from pyimcom_tpu_torch.outmaps import compress_map

    d = {k: (v.replace("$DIR", str(root)) if isinstance(v, str) else v)
         for k, v in CONFIG_TEMPLATE.items()}
    d.update(BLOCKS, OUT=str(root / "blk"))
    cfg = Config(d)
    rng = np.random.default_rng(seed)
    n = cfg.NsideP
    yy, xx = np.mgrid[0:n, 0:n]
    for bx in range(3):
        for by in range(3):
            sci = np.stack([np.sin((xx + n * bx) / 9.0) * np.cos((yy + n * by) / 11.0),
                            rng.standard_normal((n, n))])[None].astype(np.float32)
            config_hdu = TableHDU(data={"text": np.array(cfg.to_file(None).splitlines())},
                                  name="CONFIG", ascii_table=True)
            config_hdu.columns = [("text", "A512")]
            hdus = [ImageHDU(sci), config_hdu]
            # U/C 1e-7 to 1e-5 and Sigma 0.3 to 2, each block with a patch
            # above the cuts of the tests (U/C 1e-3, Sigma 3)
            uc = 10.0 ** rng.uniform(-7, -5, (1, n, n))
            sigma = rng.uniform(0.3, 2.0, (1, n, n))
            y0, x0 = rng.integers(20, n - 26, 2)
            uc[0, y0:y0 + 4, x0:x0 + 4] = 1e-3
            sigma[0, x0:x0 + 5, y0:y0 + 5] = 3.0
            for name, mp, coef, dtype, unit in (
                    ("FIDELITY", uc, -5000, np.uint16, "-0.2mB"),
                    ("SIGMA", sigma, -10000, np.int16, "-0.1mB")):
                h = ImageHDU(compress_map(mp, coef, dtype), name=name)
                h.header["UNIT"] = unit
                hdus.append(h)
            fits_write(f"{cfg.outstem}_{bx:02d}_{by:02d}.fits", HDUList(hdus))
    return f"{cfg.outstem}_01_01.fits"


@pytest.fixture(scope="module")
def mosaics(tmp_path_factory):
    """(port MetaMosaic on the CPU, JAX MetaMosaic) of the central block."""
    fname = write_blocks(tmp_path_factory.mktemp("meta"))
    return distortimage.MetaMosaic(fname, device=CPU), ref_dist.MetaMosaic(fname)


def test_metamosaic_reads_and_masks_as_reference(mosaics):
    got, want = mosaics
    assert got.Nside == want.Nside == 3 * 40 and got.nlayer == want.nlayer == 2
    for name in ("in_image", "in_fidelity", "in_noise", "in_mask"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert not got.in_mask.any()
    saved = got.in_mask.copy(), want.in_mask.copy()
    for m in (got, want):
        m.mask_fidelity_cut(40)
        m.mask_noise_cut(2.5)
    assert np.array_equal(got.in_mask, want.in_mask)
    assert 0 < got.in_mask.mean() < 1
    # examples/read_and_shear.py's noise cut, -3: the noise map holds Sigma
    # itself (not in dB, unlike the fidelity map), so it masks every pixel
    # in both packages
    for m in (got, want):
        m.mask_noise_cut(-3)
    assert np.array_equal(got.in_mask, want.in_mask) and got.in_mask.all()
    got.in_mask, want.in_mask = saved


@pytest.mark.parametrize("jac", [(0.02, 0.0), (-0.01, 0.03)], ids=["g1", "g1g2"])
def test_shearimage_matches_reference(mosaics, jac, tmp_path):
    """shearimage as examples/read_and_shear.py calls it (N the block's
    side, a shear, psfgrow 1.08) after a fidelity and a noise cut: the image within 2
    float32 spacings of its maximum, the mask, parameters, WCS and the file
    that to_file writes equal."""
    from pyimcom_tpu_torch.fitsio import fits_read

    got_m, want_m = mosaics
    g1, g2 = jac
    J = np.array([[1 - g1, -g2], [-g2, 1 + g1]])
    saved = got_m.in_mask.copy(), want_m.in_mask.copy()
    for m in (got_m, want_m):
        m.mask_fidelity_cut(40)
        m.mask_noise_cut(2.5)
    got = got_m.shearimage(40, jac=J, psfgrow=1.08)
    want = want_m.shearimage(40, jac=J, psfgrow=1.08)
    got_m.in_mask, want_m.in_mask = saved
    assert got["image"].dtype == want["image"].dtype == np.float32
    assert np.abs(got["image"].astype(np.float64) - want["image"]).max() <= 2 * np.spacing(
        np.float32(np.abs(want["image"]).max()))
    assert np.array_equal(got["mask"], want["mask"]) and not got["mask"].all()
    assert got["pars"] == want["pars"] and got["layers"] == want["layers"]
    assert got["wcs"].to_header() == want["wcs"].to_header()
    got_m.to_file(got, str(tmp_path / "port.fits"))
    want_m.to_file(want, str(tmp_path / "ref.fits"))
    a, b = fits_read(tmp_path / "port.fits"), fits_read(tmp_path / "ref.fits")
    assert [dict(h.header) for h in a] == [dict(h.header) for h in b]
    assert np.abs(np.asarray(a[0].data, np.float64) - b[0].data).max() <= 2 * np.spacing(
        np.float32(np.abs(b[0].data).max()))
    assert np.array_equal(a[1].data, b[1].data)


def test_cuda_metamosaic_without_gpu_raises(mosaics):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the card's gather runs in chip_smoke.py")
    img = np.ones((8, 8))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ginterp.MultiInterp(img, np.zeros((8, 8), bool), (4, 4), np.zeros(2),
                            np.identity(2), 2.0, 4.0, [0.0, 0.0, 0.0])
