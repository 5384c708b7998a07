"""The port's copies of the JAX package's host modules against their originals.

pyimcom_tpu_torch keeps its own copy of every jax-free host module it uses
(config, fitsio, wcsutil, sphere, asdfio, profiling, ops/psfmodels,
utils/moments, utils/compareutils, layer's helpers in layer_host,
imdestripe's host helpers, compress, truthcats, analysis, splitpsf,
update_cube and imsubtract's host helpers, piffutils's reader, writer and
Legendre quadrature, meta's InterpMatrix and MetaMosaic's reader, masks and
writer; analysis's cases on block files are in test_torch_pipeline.py).  Each case runs the copy
and the original on the same seeded inputs: configurations, FITS files,
WCS transforms and every helper must agree exactly (bit for bit, or equal
objects), since the copies are the same code.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import pyimcom_tpu.asdfio as ref_asdfio
import pyimcom_tpu.config as ref_config
import pyimcom_tpu.fitsio as ref_fitsio
import pyimcom_tpu.imdestripe as ref_imdestripe
import pyimcom_tpu.layer as ref_layer
import pyimcom_tpu.ops.psfmodels as ref_psfmodels
import pyimcom_tpu.profiling as ref_profiling
import pyimcom_tpu.sphere as ref_sphere
import pyimcom_tpu.utils.compareutils as ref_compareutils
import pyimcom_tpu.utils.moments as ref_moments
import pyimcom_tpu.wcsutil as ref_wcsutil
from pyimcom_tpu_torch import (
    asdfio, config, fitsio, imdestripe, layer_host, profiling, sphere, wcsutil)
from pyimcom_tpu_torch.ops import psfmodels
from pyimcom_tpu_torch.utils import compareutils, moments

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _same(a, b):
    """Equal values: arrays element for element (NaN where NaN), nested
    containers item by item, everything else with ==."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
            a, b, equal_nan=a.dtype.kind in "fc")
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b or (a != a and b != b)


# --------------------------------------------------------------------------
# config
# --------------------------------------------------------------------------

def _bench_cfg(tmp_path):
    from survey_fixture_torch import CONFIG_TEMPLATE

    d = {k: (v.replace("$DIR", str(tmp_path)) if isinstance(v, str) else
             [x.replace("$DIR", str(tmp_path)) if isinstance(x, str) else x for x in v]
             if isinstance(v, list) else v) for k, v in CONFIG_TEMPLATE.items()}
    return dict(d, EXTRAINPUT=["cstar14"])


CONFIGS = {
    # the bench survey's cfg.json (BASELINE.json configs[0])
    "bench": lambda tmp: _bench_cfg(tmp),
    # the production group's overrides
    "production": lambda tmp: dict(_bench_cfg(tmp), OUTSIZE=[80, 32, 0.0390625],
                                   INPAD=1.055, NPIXPSF=48, STOP=4),
    # Eigen with a kappa sweep (BASELINE.json configs[1])
    "eigen": lambda tmp: dict(_bench_cfg(tmp), LAKERNEL="Eigen",
                              KAPPAC=[5e-4, 1e-3, 2e-3]),
    # the production defaults, read from their file
    "default_file": lambda tmp: str(REPO / "configs" / "default_config.json"),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_derived_attributes_match(name, tmp_path):
    src = CONFIGS[name](tmp_path)
    if isinstance(src, dict):
        path = tmp_path / "cfg.json"
        path.write_text(json.dumps(src))
        src = str(path)
    a, b = ref_config.Config(src), config.Config(src)
    assert vars(a).keys() == vars(b).keys()
    for k in vars(a):
        assert _same(vars(a)[k], vars(b)[k]), k
    assert _same(a.to_dict(), b.to_dict())
    assert a.to_file(None) == b.to_file(None)


def test_settings_and_fpa_coords_match():
    names = [k for k in vars(ref_config.Settings) if not k.startswith("_")
             and not callable(getattr(ref_config.Settings, k))]
    assert names
    for k in names:
        assert _same(getattr(ref_config.Settings, k), getattr(config.Settings, k)), k
    rng = np.random.default_rng(0)
    x, y = rng.uniform(0, 4088, (2, 50))
    for sca in (1, 9, 18):
        assert _same(ref_config.fpaCoords.pix2fpa(sca, x, y),
                     config.fpaCoords.pix2fpa(sca, x, y))


# --------------------------------------------------------------------------
# FITS
# --------------------------------------------------------------------------

def _hdus(mod, rng):
    hdr = mod.Header({"EXPTIME": 139.8, "FILTER": "F184", "GOODVAL": 0, "FLAG": True})
    return mod.HDUList([
        mod.ImageHDU(rng.normal(size=(7, 9)).astype(np.float32), header=hdr),
        mod.ImageHDU(rng.normal(size=(3, 4, 5)), name="CUBE"),
        mod.ImageHDU(rng.integers(-300, 300, (6, 6)).astype(np.int16), name="I16"),
        mod.TableHDU({"ra": rng.normal(size=5), "n": np.arange(5, dtype=np.int32),
                      "f": np.array(["F184", "H158", "F184", "J129", "Y106"])}, name="OBS"),
        mod.TableHDU({"text": np.array(["{", '"A": 1', "}"])}, name="CONFIG",
                     ascii_table=True),
    ])


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_fits_written_by_one_package_reads_the_same_in_the_other(writer, tmp_path):
    w, r = (ref_fitsio, fitsio) if writer == "ref" else (fitsio, ref_fitsio)
    path = tmp_path / "x.fits"
    w.fits_write(path, _hdus(w, np.random.default_rng(1)))
    got, want = r.fits_read(path), w.fits_read(path)
    assert len(got) == len(want) == 5
    for g, h in zip(got, want):
        assert dict(g.header) == dict(h.header)
        if g.is_table:
            assert g.names == h.names
            for col in g.names:
                assert _same(np.asarray(g[col]), np.asarray(h[col])), col
        else:
            assert _same(np.asarray(g.data), np.asarray(h.data))


# --------------------------------------------------------------------------
# WCS
# --------------------------------------------------------------------------

WCS_CASES = {
    "STG": dict(ctype=("RA---STG", "DEC--STG"), crval=(60.05, -3.8), crpix=(1250.0, 1250.0),
                cd=np.diag([-0.04, 0.04]) / 3600, lonpole=240.0),
    "TAN": dict(ctype=("RA---TAN", "DEC--TAN"), crval=(10.0, 45.0), crpix=(2043.5, 2043.5),
                cd=np.array([[-0.11, 0.02], [0.02, 0.11]]) / 3600),
    "ARC": dict(ctype=("RA---ARC", "DEC--ARC"), crval=(60.1, -3.75), crpix=(2043.5, 2043.5),
                cd=np.array([[-0.9, 0.4], [0.4, 0.9]]) * 0.11 / 3600, lonpole=200.0),
}


@pytest.mark.parametrize("proj", sorted(WCS_CASES))
def test_wcs_transforms_are_bit_equal(proj):
    a, b = ref_wcsutil.WCS(**WCS_CASES[proj]), wcsutil.WCS(**WCS_CASES[proj])
    rng = np.random.default_rng(2)
    x, y = rng.uniform(-100, 4200, (2, 300))
    ra, dec = a.pix2world(x, y)
    assert _same((ra, dec), b.pix2world(x, y))
    assert _same(a.world2pix(ra, dec), b.world2pix(ra, dec))
    assert _same(a.to_header(), b.to_header())
    for px, py in ((0.0, 0.0), (2043.5, 1000.25)):
        assert _same(ref_wcsutil.local_partial_pixel_derivatives2(a, px, py),
                     wcsutil.local_partial_pixel_derivatives2(b, px, py))


@pytest.mark.parametrize("name", ["bench", "production"])
def test_block_wcs_is_bit_equal(name, tmp_path):
    src = CONFIGS[name](tmp_path)
    a = ref_wcsutil.make_block_wcs(ref_config.Config(src), 1, 0)
    b = wcsutil.make_block_wcs(config.Config(src), 1, 0)
    assert _same(a.to_header(), b.to_header())
    x, y = np.random.default_rng(3).uniform(0, 100, (2, 200))
    assert _same(a.pix2world(x, y), b.pix2world(x, y))


def test_wcs_header_round_trip_through_the_other_package(tmp_path):
    a = ref_wcsutil.WCS(**WCS_CASES["TAN"])
    b = wcsutil.WCS.from_header(fitsio.Header(a.to_header()))
    x, y = np.random.default_rng(4).uniform(0, 4088, (2, 100))
    assert _same(a.pix2world(x, y), b.pix2world(x, y))


# --------------------------------------------------------------------------
# PSF models, sphere, moments
# --------------------------------------------------------------------------

PSF_CASES = {
    "gaussian": lambda m: m.psf_gaussian(48, 2.1, 2.6),
    "simple_airy": lambda m: m.psf_simple_airy(48, 4.2, obsc=0.31, tophat_conv=6.0,
                                               sigma=1.1),
    "cplx_airy": lambda m: m.psf_cplx_airy(60, 7.956, sigma=1.8, features=5),
    "smooth_and_pad": lambda m: m.smooth_and_pad(m.psf_gaussian(40, 3.0, 3.0),
                                                 tophatwidth=6.0),
    "smooth_and_pad_batch": lambda m: m.smooth_and_pad_batch(
        np.stack([m.psf_gaussian(40, s, s) for s in (2.0, 3.0)]), tophatwidth=6.0),
    "legendre": lambda m: m.legendre_poly_array(3, 0.3, -0.6),
    "cube": lambda m: m.eval_psf_cube(np.random.default_rng(5).normal(size=(16, 20, 20)),
                                      1234.5, 321.0),
    "cube_batch": lambda m: m.eval_psf_cube_batch(
        np.random.default_rng(5).normal(size=(9, 24, 24)),
        np.array([100.0, 2000.0]), np.array([3000.0, 40.0])),
}


@pytest.mark.parametrize("name", sorted(PSF_CASES))
def test_psfmodels_match(name):
    assert _same(PSF_CASES[name](ref_psfmodels), PSF_CASES[name](psfmodels))


def test_healpix_patch_matches():
    for res, ra, dec, rad in ((10, 1.05, -0.066, 0.002), (14, 0.3, 0.9, 0.0007)):
        assert _same(ref_sphere.healpix_patch(res, ra, dec, rad),
                     sphere.healpix_patch(res, ra, dec, rad))


def test_generate_star_grid_matches():
    a = ref_wcsutil.WCS(**WCS_CASES["ARC"])
    b = wcsutil.WCS(**WCS_CASES["ARC"])
    got = layer_host.generate_star_grid(12, b)
    assert len(got[0]) > 10
    assert _same(ref_layer.generate_star_grid(12, a), got)


def test_noise_frame_and_seed_match():
    seed = layer_host.layer_seed(2, (7, 11))
    assert seed == ref_layer.layer_seed(2, (7, 11))
    assert _same(ref_layer.noise_1f_frame(seed), layer_host.noise_1f_frame(seed))


@pytest.mark.parametrize("n", [0.5, 1.0, 2.3])
def test_galaxy_profiles_match(n):
    u = np.fft.rfftfreq(64)[None, :]
    v = np.fft.fftfreq(64)[:, None]
    M = ref_layer._shear_matrix(0.2, 0.1) @ ref_layer._shear_expm(0.05, -0.02)
    assert _same(M, layer_host._shear_matrix(0.2, 0.1) @ layer_host._shear_expm(0.05, -0.02))
    A = np.array([[-0.015, 0.004], [0.003, 0.016]])
    assert _same(ref_layer.galaxy_ft(u, v, n, 0.1, M, A),
                 layer_host.galaxy_ft(u, v, n, 0.1, M, A))


def test_gsext_args_match():
    args = ["n=1.5", "hlr=0.2", "shape=0.2:0.1", "shear=0.01:-0.02", "rot=30", "seed=7",
            "junk"]
    assert layer_host.parse_gsext_args(args) == ref_layer.parse_gsext_args(args)


def test_masks_match(tmp_path):
    """The mask-file and permanent-mask readers (the cosmic-ray mask draws
    an 18 x 4108^2 random cube and is left to the block tests)."""
    from types import SimpleNamespace

    rng = np.random.default_rng(6)
    m = (rng.random((32, 32)) < 0.1).astype(np.uint8)
    (tmp_path / "in").mkdir()
    fitsio.fits_write(tmp_path / "in" / "sim_L2_F184_3_5_mask.fits",
                      fitsio.HDUList([fitsio.ImageHDU(None), fitsio.ImageHDU(m, name="MASK")]))
    fitsio.fits_write(tmp_path / "pmask.fits", fitsio.HDUList([fitsio.ImageHDU(
        m, header=fitsio.Header({"GOODVAL": 0}))]))
    cfg = SimpleNamespace(inpath=str(tmp_path / "in"), informat="L2_fits",
                          permanent_mask=str(tmp_path / "pmask.fits"), cr_mask_rate=0.0)
    obs = "F184"                                # the filter, as a name
    for idsca in ((3, 5), (2, 5)):             # with and without a mask file
        assert _same(ref_layer.Mask.load_mask_from_maskfile(cfg, obs, idsca),
                     layer_host.Mask.load_mask_from_maskfile(cfg, obs, idsca))
        assert _same(ref_layer.get_sca_imagefile(cfg.inpath, idsca, obs, "L2_fits"),
                     layer_host.get_sca_imagefile(cfg.inpath, idsca, obs, "L2_fits"))
    blk = SimpleNamespace(cfg=cfg)
    assert _same(ref_layer.Mask.load_permanent_mask(blk),
                 layer_host.Mask.load_permanent_mask(blk))
    img = SimpleNamespace(blk=blk, idsca=(3, 5))
    assert ref_layer.Mask.load_cr_mask(img) is layer_host.Mask.load_cr_mask(img) is None


def test_adaptive_moments_match():
    yy, xx = np.mgrid[0:41, 0:41]
    img = np.exp(-0.5 * (((xx - 20.3) / 3.1) ** 2 + ((yy - 19.6) / 2.4) ** 2
                         + 0.3 * (xx - 20.3) * (yy - 19.6) / 7.4))
    img += np.random.default_rng(7).normal(scale=1e-3, size=img.shape)
    a = ref_moments.find_adaptive_moments(img, guess_sigma=3.0)
    b = moments.find_adaptive_moments(img, guess_sigma=3.0)
    assert a.converged and vars(a) == vars(b)
    assert _same(ref_moments.fourth_moments(img, a), moments.fourth_moments(img, b))


# --------------------------------------------------------------------------
# asdfio, profiling
# --------------------------------------------------------------------------

def test_asdf_written_by_one_package_reads_the_same_in_the_other(tmp_path):
    tree = {"roman": {"meta": {"exptime": 139.8}, "data": np.arange(12.0).reshape(3, 4)},
            "noise": np.ones((2, 2, 2), np.float32)}
    ref_asdfio.asdf_write(tmp_path / "a.asdf", tree)
    asdfio.asdf_write(tmp_path / "b.asdf", tree)
    for path in ("a.asdf", "b.asdf"):
        got = asdfio.asdf_read(tmp_path / path)
        want = ref_asdfio.asdf_read(tmp_path / path)
        assert _same(np.asarray(got["roman"]["data"]), np.asarray(want["roman"]["data"]))
        assert _same(np.asarray(got["noise"]), np.asarray(want["noise"]))
        assert got["roman"]["meta"] == want["roman"]["meta"]


def test_profiling_matches(monkeypatch, capsys):
    monkeypatch.setenv("PYIMCOM_PROFILE", "1")
    for mod in (ref_profiling, profiling):
        mod.reset()
        with mod.phase("a"):
            pass
        mod.report("x")
        assert mod.enabled() and set(mod._ACC) == {"a"} and mod._CNT["a"] == 1
        mod.reset()
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 4 and out[0].split("(")[0] == out[2].split("(")[0]


# --------------------------------------------------------------------------
# compareutils, imdestripe's host helpers
# --------------------------------------------------------------------------

def _sca_wcs(mod, k):
    """Three overlapping Roman-like SCAs (ARC, 0.11" pixels, rotated)."""
    rho = np.deg2rad(20.0 + 15.0 * k)
    cd = np.array([[-np.cos(rho), np.sin(rho)], [np.sin(rho), np.cos(rho)]]) * 0.11 / 3600
    return mod.WCS(ctype=("RA---ARC", "DEC--ARC"),
                   crval=(60.05 + 0.002 * k, -3.8 + 0.001 * k),
                   crpix=(200.5 + 7 * k, 200.5 - 5 * k), cd=cd, lonpole=200.0)


@pytest.mark.parametrize("pad, subsamp, dtype", [(0, 1, np.float64), (3, 4, np.float32)],
                         ids=["full", "padded-subsampled-f32"])
def test_map_sca2sca_is_bit_equal(pad, subsamp, dtype):
    a = [_sca_wcs(ref_wcsutil, k) for k in (0, 1)]
    b = [_sca_wcs(wcsutil, k) for k in (0, 1)]
    got = compareutils.map_sca2sca(*b, pad=pad, dtype=dtype, subsamp=subsamp, nside=400)
    assert np.count_nonzero(got[2]) > 1000
    assert _same(ref_compareutils.map_sca2sca(*a, pad=pad, dtype=dtype, subsamp=subsamp,
                                              nside=400), got)


def test_overlap_matrix_and_footprints_are_bit_equal():
    a = [_sca_wcs(ref_wcsutil, k) for k in range(3)]
    b = [_sca_wcs(wcsutil, k) for k in range(3)]
    got = compareutils.get_overlap_matrix(b, subsamp=8, nside=400)
    assert np.all(got > 0.1)
    assert _same(ref_compareutils.get_overlap_matrix(a, subsamp=8, nside=400), got)
    assert _same(ref_compareutils.getfootprint(a[1], 2, nside=400),
                 compareutils.getfootprint(b[1], 2, nside=400))
    assert compareutils.str2dirstem("a/b/c") == ref_compareutils.str2dirstem("a/b/c")


def test_g_eff_is_bit_equal():
    assert _same(ref_imdestripe.compute_g_eff(_sca_wcs(ref_wcsutil, 1), (40, 50)),
                 imdestripe.compute_g_eff(_sca_wcs(wcsutil, 1), (40, 50)))


@pytest.mark.parametrize("kind", ["fits", "jwst", "given"])
def test_object_mask_is_bit_equal(kind):
    rng = np.random.default_rng(8)
    img = rng.normal(scale=0.05, size=(80, 80))
    img[30, 30], img[60, 10:14] = 50.0, 2.0
    kw = dict(mask=rng.random((80, 80)) > 0.9) if kind == "given" else dict(
        type=kind, threshold_m=15.0 if kind == "jwst" else 0.0,
        threshold_c=5.0 if kind == "jwst" else 0.3)
    got = imdestripe.apply_object_mask(img.copy(), **kw)
    assert np.any(got[1])
    assert _same(ref_imdestripe.apply_object_mask(img.copy(), **kw), got)


def test_stripe_model_is_bit_equal():
    rng = np.random.default_rng(9)
    shape, amp = (32, 48), 16
    p = rng.normal(size=imdestripe.n_params(shape, amp))
    assert imdestripe.n_params(shape, amp) == ref_imdestripe.n_params(shape, amp)
    assert _same(ref_imdestripe.forward_par(p, shape, amp), imdestripe.forward_par(p, shape, amp))
    img = rng.normal(size=shape)

    class C:
        amp_cols = amp

    assert _same(ref_imdestripe.transpose_par(img, C()), imdestripe.transpose_par(img, C()))
    assert _same(ref_imdestripe.transpose_par(img), imdestripe.transpose_par(img))


def test_boundary_penalty_and_gradient_are_bit_equal():
    rng = np.random.default_rng(10)
    img = rng.normal(size=(100, 64))
    mask = rng.random((100, 64)) > 0.2
    kw = dict(amp_cols=32, col_boundary_const=1.7, chunk_width=16, chunk_height=40)
    got = imdestripe.compute_boundary_continuity_penalty(img, mask, **kw)
    assert got > 0
    assert got == ref_imdestripe.compute_boundary_continuity_penalty(img, mask, **kw)
    assert _same(ref_imdestripe.boundary_continuity_penalty_grad_image(img, mask, **kw),
                 imdestripe.boundary_continuity_penalty_grad_image(img, mask, **kw))


@pytest.mark.parametrize("model", ["quadratic", "absolute", "huber_loss"])
def test_penalty_is_bit_equal(model):
    r = np.random.default_rng(11).normal(size=200)
    assert _same(ref_imdestripe.penalty(r, model, 0.7), imdestripe.penalty(r, model, 0.7))


# --------------------------------------------------------------------------
# compress, truthcats, analysis's helpers
# --------------------------------------------------------------------------

import pyimcom_tpu.analysis as ref_analysis  # noqa: E402
import pyimcom_tpu.compress as ref_compress  # noqa: E402
import pyimcom_tpu.truthcats as ref_truthcats  # noqa: E402
from pyimcom_tpu_torch import analysis, compress, truthcats  # noqa: E402

I24_PARS = {
    # layer_wrapper.I24B_PARS, compress_all_blocks's parameters
    "diff-smallnum": {"VMIN": "-100.0", "VMAX": "100.0", "DIFF": "True", "SOFTBIAS": "-1"},
    # a soft bias, a power law, fewer bits and no bit transpose
    "softbias-alpha": {"VMIN": -5.0, "VMAX": 7.0, "SOFTBIAS": 1000, "ALPHA": 0.5,
                       "BITKEEP": 20, "REORDER": False},
}


def _layer_image(seed, shape=(40, 56)):
    """float32 image with values beyond both ends of [-100, 100] and [-5, 7]."""
    rng = np.random.default_rng(seed)
    im = rng.normal(scale=3.0, size=shape).astype(np.float32)
    im[3, 5], im[17, 2], im[30, 40] = 250.0, -180.0, 6.5
    return im


@pytest.mark.parametrize("scheme", ["I24A", "I24B"])
@pytest.mark.parametrize("pars", sorted(I24_PARS))
def test_i24_codec_is_bit_equal(scheme, pars):
    im = _layer_image(12)
    want, ovf_want = ref_compress.i24compress(im, scheme, I24_PARS[pars])
    got, ovf_got = compress.i24compress(im, scheme, I24_PARS[pars])
    assert _same(want, got) and _same(ovf_want, ovf_got)
    assert len(ovf_got["y"]) > 0                       # the overflow table is used
    back = compress.i24decompress(got, scheme, I24_PARS[pars], overflow=ovf_got)
    assert _same(ref_compress.i24decompress(want, scheme, I24_PARS[pars], overflow=ovf_want),
                 back)
    assert back[3, 5] == 250.0 and back[17, 2] == -180.0   # restored exactly


def _block_file(mod, path):
    """A block-like file: a (1, 3, ny, nx) float32 cube and a second HDU."""
    cube = np.stack([_layer_image(s) for s in (20, 21, 22)])[None]
    mod.fits_write(path, mod.HDUList([
        mod.ImageHDU(cube), mod.ImageHDU(np.arange(12, dtype=np.int16).reshape(3, 4),
                                         name="FIDELITY")]))


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_compressed_output_round_trip_is_bit_equal(writer, tmp_path):
    """CompressedOutput of layers 1-2 to .cpr.fits.gz by one package; both
    ReadFile copies restore the same HDUs, and the layers within the I24B
    step of the original."""
    co_mod = ref_compress if writer == "ref" else compress
    _block_file(ref_fitsio if writer == "ref" else fitsio, tmp_path / "b.fits")
    co = co_mod.CompressedOutput(str(tmp_path / "b.fits"))
    for il in (1, 2):
        co.compress_layer(il, "I24B", I24_PARS["diff-smallnum"])
    packed = str(tmp_path / "b.cpr.fits.gz")
    co.to_file(packed)
    want, got = ref_compress.ReadFile(packed), compress.ReadFile(packed)
    # the compressed planes (HSHX*) and overflow tables (HSHV*) are restored
    # and removed; the CPRESS table of the scheme parameters stays
    assert [h.name for h in want] == [h.name for h in got] == ["", "FIDELITY", "CPRESS"]
    assert list(got["CPRESS"].data["text"]) == list(want["CPRESS"].data["text"])
    for hw, hg in zip(want[:2], got[:2]):
        assert _same(np.asarray(hw.data), np.asarray(hg.data))
    orig = fitsio.fits_read(str(tmp_path / "b.fits"))[0].data
    assert _same(got[0].data[0, 0], orig[0, 0])
    step = 200.0 / 2 ** 24
    assert np.abs(got[0].data[0, 1:] - orig[0, 1:]).max() <= step + np.spacing(np.float32(250))


def _truth_cfg(tmp_path, mod):
    """A 2x2 mosaic configuration with star, galaxy and noise layers, whose
    blocks (0, 0), (0, 1) and (1, 1) have (empty) output files."""
    d = dict(_bench_cfg(tmp_path), OUTSIZE=[8, 64, 0.04], PAD=1,
             EXTRAINPUT=["cstar14", "gsext14,n=1.5,hlr=0.2,shape=0.1:0.2,rot=20,shear=0.02:0.01,"
                                    "seed=7", "nstar14,2.0", "whitenoise1"])
    (tmp_path / "out").mkdir(exist_ok=True)
    for ibx, iby in ((0, 0), (0, 1), (1, 1)):
        (tmp_path / "out" / f"testout_F_{ibx:02d}_{iby:02d}.fits").touch()
    return mod.Config(d)


def test_truth_catalogs_are_bit_equal(tmp_path):
    want = ref_truthcats.gen_truthcats_from_cfg(_truth_cfg(tmp_path, ref_config),
                                                str(tmp_path / "ref_TruthCat.fits"))
    got = truthcats.gen_truthcats_from_cfg(_truth_cfg(tmp_path, config),
                                           str(tmp_path / "port_TruthCat.fits"))
    a, b = ref_fitsio.fits_read(want), fitsio.fits_read(got)
    assert [h.name for h in a] == [h.name for h in b] == [
        "", "TRUTH14_CSTAR", "TRUTH14_GSEXT", "TRUTH14_NSTAR"]
    for ha, hb in zip(a[1:], b[1:]):
        assert dict(ha.header) == dict(hb.header)
        assert list(ha.data) == list(hb.data) and len(hb.data["ipix"]) > 0
        for col in ha.data:
            assert _same(np.asarray(ha.data[col]), np.asarray(hb.data[col])), (ha.name, col)
    cfg_r, cfg_p = _truth_cfg(tmp_path, ref_config), _truth_cfg(tmp_path, config)
    cfg_r(), cfg_p()
    for ibx, iby in ((0, 0), (1, 0)):
        pos = truthcats.block_truth_positions(cfg_p, ibx, iby, 14)
        assert len(pos["ipix"]) > 0
        assert _same(ref_truthcats.block_truth_positions(cfg_r, ibx, iby, 14), pos)


@pytest.mark.parametrize("unit, dtype", [("-0.2mB", np.int16), ("5uB", np.uint16),
                                         ("0.1dB", ">u2")])
def test_quality_map_decoding_is_bit_equal(unit, dtype):
    rng = np.random.default_rng(13)
    info = np.iinfo(np.dtype(dtype))
    data = rng.integers(info.min, info.max, size=(3, 20, 20), endpoint=True).astype(dtype)
    data[0, 0, :2] = info.min, info.max
    assert ref_analysis.unit_to_bels(unit) == analysis.unit_to_bels(unit)
    assert _same(ref_analysis.decode_quality_map(data, unit),
                 analysis.decode_quality_map(data, unit))


def test_noise_spectrum_helpers_are_bit_equal():
    ra, pa = ref_analysis.NoiseAnal, analysis.NoiseAnal
    img = np.random.default_rng(14).normal(size=(64, 64))
    assert _same(ra.azimuthal_average(img, 8), pa.azimuthal_average(img, 8))
    assert _same(ra.tukey_window((48, 40), 0.7), pa.tukey_window((48, 40), 0.7))
    assert _same(ra.get_wavenumbers(64, 4), pa.get_wavenumbers(64, 4))
    for layer in ("whitenoise1", "1fnoise2", "labnoise", "other"):
        assert ra.get_norm(layer, 64, "F184", 0.04) == pa.get_norm(layer, 64, "F184", 0.04)


class _StarBlock:
    """The parts of an OutImage that StarsAnal reads: the configuration of
    _truth_cfg's block (ibx, iby) and a layer with a noisy, slightly
    elliptical Gaussian star at each of the block's cstar14 truth positions."""

    def __init__(self, tmp_path, ibx, iby):
        self.cfg = _truth_cfg(tmp_path, config)
        self.cfg()
        self.ibx, self.iby = ibx, iby
        pos = truthcats.block_truth_positions(self.cfg, ibx, iby, 14)
        n = self.cfg.NsideP
        y, x = np.mgrid[0:n, 0:n]
        img = 1e-3 * np.random.default_rng(15).normal(size=(n, n))
        for px, py in zip(pos["x"], pos["y"]):
            img += np.exp(-0.5 * (1.1 * (x - px) ** 2 + 0.9 * (y - py) ** 2
                                  + 0.2 * (x - px) * (y - py)) / 2.5 ** 2)
        self.img = img.astype(np.float32)

    def get_coadded_layer(self, layer, j_out=0):
        return self.img


def test_star_catalog_is_bit_equal(tmp_path):
    blk = _StarBlock(tmp_path, 0, 1)
    want = ref_analysis.StarsAnal(blk, layer="cstar14").catalog()
    got = analysis.StarsAnal(blk, layer="cstar14").catalog()
    assert list(got) == analysis.StarsAnal.COLUMNS and got["converged"].sum() > 0
    assert _same(want, got)


# --------------------------------------------------------------------------
# splitpsf: the split (splitpsf.py), the cache update (update_cube.py) and
# imsubtract's host helpers
# --------------------------------------------------------------------------

def _psf_cube(npoly=4, n=72):
    cube = np.zeros((npoly, n, n))
    cube[0] = psfmodels.psf_cplx_airy(n, 6 * 1.326, sigma=6 * 0.3, features=2)
    cube[1:] = 0.02 * np.random.default_rng(21).normal(size=(npoly - 1, n, n)) * cube[0]
    return cube


@pytest.mark.parametrize("distortion", ["none", "wcs"])
def test_split_psf_is_bit_equal(distortion):
    """SplitPSF.build, without a WCS and with one (the Gamma covariance from
    the local pixel derivatives): every array the same."""
    from pyimcom_tpu.splitpsf.splitpsf import SplitPSF as RefSplit
    from pyimcom_tpu_torch.splitpsf.splitpsf import SplitPSF

    pars = {"smallstamp_size": 48, "sigmaGamma": 0.93, "r_in": 3.0, "r_out": 6.0,
            "eps": 0.01, "oversamp": 6}
    w = WCS_CASES["ARC"] if distortion == "wcs" else None
    a = RefSplit(_psf_cube(), ref_wcsutil.WCS(**w) if w else None, pars)
    b = SplitPSF(_psf_cube(), wcsutil.WCS(**w) if w else None, pars)
    a.build()
    b.build()
    for name in ("psfcube", "smallpsf", "K_Legendre", "K_real", "zeta_real", "Cov"):
        assert _same(getattr(a, name), getattr(b, name)), name


def test_split_psf_file_is_bit_equal(tmp_path):
    """split_psf_to_fits with a per-SCA WCS list and SAVEZETA: the same
    bytes."""
    from pyimcom_tpu.splitpsf.splitpsf import split_psf_to_fits as ref_split
    from pyimcom_tpu_torch.splitpsf.splitpsf import split_psf_to_fits

    cube = _psf_cube(n=48).astype(np.float32)
    fitsio.fits_write(tmp_path / "psf.fits", fitsio.HDUList(
        [fitsio.ImageHDU(None)] + [fitsio.ImageHDU(cube) for _ in range(2)]))
    pars = {"oversamp": 6, "r_in": 2.0, "r_out": 3.5, "SAVEZETA": True}
    ref_split(str(tmp_path / "psf.fits"),
              [ref_wcsutil.WCS(**WCS_CASES["TAN"]), None], pars, str(tmp_path / "a.fits"))
    split_psf_to_fits(str(tmp_path / "psf.fits"),
                      [wcsutil.WCS(**WCS_CASES["TAN"]), None], pars, str(tmp_path / "b.fits"))
    assert (tmp_path / "a.fits").read_bytes() == (tmp_path / "b.fits").read_bytes()


def test_update_cube_is_the_same(tmp_path):
    """Both packages' update on twin caches: the same swapped files,
    archive, iteration counters and history (up to the cache's path)."""
    from pyimcom_tpu.splitpsf.update_cube import update as ref_update
    from pyimcom_tpu_torch.splitpsf.update_cube import update

    def cache(name):
        root = tmp_path / name
        root.mkdir()
        for obsid, sca in ((3, 1), (7, 1), (7, 4)):
            (root / f"in_{obsid:08d}_{sca:02d}.fits").write_text(f"old {obsid} {sca}")
            if sca == 1:
                (root / f"in_{obsid:08d}_{sca:02d}_subI.fits").write_text(f"new {obsid}")
        return str(root / "in")

    def listing(root):
        return {str(p.relative_to(root)): p.read_text().replace(str(root), "ROOT")
                for p in sorted(root.rglob("*")) if p.is_file()}

    src = _bench_cfg(tmp_path)
    for name, fn, mod in (("ref", ref_update, ref_config), ("port", update, config)):
        c = cache(name)
        cfg = mod.Config(dict(src, INLAYERCACHE=c))
        assert [fn(cfg), fn(cfg)] == [1, 2]
    assert listing(tmp_path / "ref") == listing(tmp_path / "port")


def test_imsubtract_host_helpers_are_bit_equal():
    """The Tukey windows, reinterp and the 2x2 kernel binning (the trimming
    branch at oversampling 6, the padding branch at 4)."""
    import pyimcom_tpu.splitpsf.imsubtract as ref_imsub
    from pyimcom_tpu_torch.splitpsf import imsubtract

    for n, width in ((30, 10), (17, 0), (9, 4), (64, 12)):
        assert _same(ref_imsub.tukey_window_1d(n, width), imsubtract.tukey_window_1d(n, width))
        assert _same(ref_imsub.tukey_window_2d(n, width), imsubtract.tukey_window_2d(n, width))
    arr = np.random.default_rng(22).normal(size=(26, 30))
    assert _same(ref_imsub.reinterp(arr), imsubtract.reinterp(arr))
    for ov, n in ((6, 48), (4, 40)):
        K = np.random.default_rng(ov).normal(size=(3, n, n))
        assert _same(ref_imsub.bin_kernel_2x2(K, ov), imsubtract.bin_kernel_2x2(K, ov))


# --------------------------------------------------------------------------
# Piff input and metadetection
# --------------------------------------------------------------------------

@pytest.mark.parametrize("chips", [False, True], ids=["one", "per-chip"])
def test_piff_file_writer_and_reader_are_bit_equal(chips, tmp_path):
    """write_piff_file: the same bytes; PiffPSFModel: the same grid, basis
    and parameters from either file."""
    import pyimcom_tpu.utils.piffutils as ref_piff
    from pyimcom_tpu_torch.utils import piffutils

    rng = np.random.default_rng(31)
    size, order = 11, 1
    q = {0: rng.normal(size=(size * size, 3)), 6: rng.normal(size=(size * size, 3))}
    q = q if chips else q[0]
    ref_piff.write_piff_file(str(tmp_path / "a.piff"), q, size, order, scale=0.25)
    piffutils.write_piff_file(str(tmp_path / "b.piff"), q, size, order, scale=0.25)
    assert (tmp_path / "a.piff").read_bytes() == (tmp_path / "b.piff").read_bytes()
    for sca in (1, 7):
        a = ref_piff.PiffPSFModel(str(tmp_path / "a.piff"), sca)
        b = piffutils.PiffPSFModel(str(tmp_path / "a.piff"), sca)
        assert (a.scale, a.size, a.order, a.exponents) == (b.scale, b.size, b.order, b.exponents)
        assert _same(a.q, b.q)
        assert _same(a.basis(1000.5, 17.0), b.basis(1000.5, 17.0))
        assert _same(a.params(1000.5, 17.0), b.params(1000.5, 17.0))


def test_legendre_quadrature_is_bit_equal():
    """psf_stamps_to_legendre_cube on the same drawing function."""
    import pyimcom_tpu.utils.piffutils as ref_piff
    from pyimcom_tpu_torch.utils import piffutils

    def draw(x, y):
        r = np.random.default_rng(int(x * 7 + y))
        return r.normal(size=(9, 9)) * (1 + x / 4088.0)

    for lorder in (0, 2):
        assert _same(ref_piff.psf_stamps_to_legendre_cube(draw, lorder),
                     piffutils.psf_stamps_to_legendre_cube(draw, lorder))


@pytest.mark.parametrize("cov", [[0.0, 0.0, 0.0], [1.5, 0.3, 0.9]], ids=["none", "smooth"])
def test_interp_matrix_is_bit_equal(cov):
    import pyimcom_tpu.meta.ginterp as ref_ginterp
    from pyimcom_tpu_torch.meta import ginterp

    r = np.random.default_rng(5)
    x, y = r.uniform(0, 1, 200), r.uniform(0, 1, 200)
    for Rsearch, samp, stest in ((6.0, 4.0, 1), (3.5, 2.7, 3)):
        assert _same(ref_ginterp.InterpMatrix(Rsearch, samp, x, y, cov, stest=stest),
                     ginterp.InterpMatrix(Rsearch, samp, x, y, cov, stest=stest))


def test_metamosaic_reader_masks_and_writer_are_the_same(tmp_path):
    """MetaMosaic on a 3x3 block set and on a 1-pixel extension (extpix), its
    masks (fidelity, noise, caps, a pixel mask), origimage and to_file."""
    from pyimcom_tpu.meta.distortimage import MetaMosaic as RefMetaMosaic
    from test_torch_meta import write_blocks
    from pyimcom_tpu_torch.meta.distortimage import MetaMosaic

    fname = write_blocks(tmp_path)
    for kw in ({}, {"extpix": 7}, {"bbox": (0, 2, 1, 3)}):
        a, b = RefMetaMosaic(fname, **kw), MetaMosaic(fname, device="cpu", **kw)
        for name in ("nlayer", "im_dtype", "stem", "ix", "iy", "trunc", "Nside",
                     "in_image", "in_fidelity", "in_noise", "in_mask"):
            assert _same(getattr(a, name), getattr(b, name)), (kw, name)
        assert a.wcs.to_header() == b.wcs.to_header()
        extra = np.zeros((a.Nside, a.Nside), dtype=bool)
        extra[3:5, 8:9] = True
        for m in (a, b):
            m.mask_fidelity_cut(40)
            m.mask_noise_cut(2.5)
            m.maskpix(extra)
            m.mask_caps([60.0504], [-3.8], [2e-4])
        assert _same(a.in_mask, b.in_mask)
        oa, ob = a.origimage(N=21, select_layers=[1]), b.origimage(N=21, select_layers=[1])
        assert _same(oa["image"], ob["image"]) and _same(oa["mask"], ob["mask"])
        assert oa["layers"] == ob["layers"]
        a.to_file(oa, str(tmp_path / "a.fits"))
        b.to_file(ob, str(tmp_path / "b.fits"))
        assert (tmp_path / "a.fits").read_bytes() == (tmp_path / "b.fits").read_bytes()
