"""Piff PSF input in the port, pyimcom_tpu_torch.utils.piffutils and the
coadd's Piff branches, against the JAX package on the CPU.

Twins of the four fast tests of tests/test_piff.py run through both
packages: the reader gives the same q bit for bit, and the port's draws
(``device="cpu"``: the plain grid interpolation in float64) satisfy the
same criteria.  The port's draw equals the JAX draw within one float32
spacing of max|stamp| (both round a float64 interpolation to float32), at
order 0 and 2, with and without normbox; a batched draw equals the single
draws exactly; the Legendre conversion (one file, and the multi-SCA file)
is within 2 float32 spacings of max|cube[0]|.  The Piff block is the twin
of test_block_with_piff_psf_input at STOP 1 on the shared small_survey of
test_torch_block.py: its Piff files are written as tests/test_piff.py:115-127
writes them, and the port's CPU Block matches the reference Block within
compare_outputs_f32's bounds, with a U/C median below 1e-2 as the JAX test
asserts.
"""

import numpy as np
import pytest
import torch

import pyimcom_tpu.utils.piffutils as ref
from test_torch_block import _cfg, compare_outputs_f32, small_survey  # noqa: F401
from pyimcom_tpu_torch.utils import piffutils

torch.set_num_threads(1)
CPU = "cpu"


def _gauss_grid(size, sigma):
    c = (size - 1) / 2.0
    y, x = np.mgrid[0:size, 0:size]
    g = np.exp(-0.5 * ((x - c) ** 2 + (y - c) ** 2) / sigma ** 2)
    return g / g.sum()


def _varying_model(tmp_path, order, size=21, scale=0.5, seed=0):
    """A Gaussian PixelGrid with seeded polynomial terms of 1e-3 of its peak,
    written by the port's writer; (path, q)."""
    nb = (order + 1) * (order + 2) // 2
    rng = np.random.default_rng(seed)
    g = _gauss_grid(size, 2.5)
    q = 1e-3 * g.max() * rng.standard_normal((size * size, nb))
    q[:, 0] = g.ravel()
    fname = str(tmp_path / f"ffov_{order}.piff")
    piffutils.write_piff_file(fname, q, size, order, scale=scale)
    return fname, q


def _within_f32(got, want, spacings):
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    bound = spacings * np.spacing(np.float32(np.abs(want).max()))
    assert np.abs(got.astype(np.float64) - want).max() <= bound


def test_roundtrip_and_spatial_variation(tmp_path):
    """write_piff_file -> PiffPSFModel reproduces the polynomial params, and
    both packages read the same q and params."""
    size, order = 15, 2
    nb = (order + 1) * (order + 2) // 2
    rng = np.random.default_rng(0)
    q = rng.standard_normal((size * size, nb))
    fname = str(tmp_path / "ffov_1.piff")
    piffutils.write_piff_file(fname, q, size, order, scale=1.0)

    model = piffutils.PiffPSFModel(fname, sca=3, nside=4088)
    want = ref.PiffPSFModel(fname, sca=3, nside=4088)
    assert model.size == size and model.order == order
    assert np.array_equal(model.q, want.q) and model.q.dtype == want.q.dtype
    np.testing.assert_allclose(model.q, q, rtol=0, atol=1e-12)

    x, y = 1000.0, 3000.0
    half = (4088 - 1) / 2.0
    u, v = (x - half) / half, (y - half) / half
    basis = np.array([u ** i * v ** j
                      for j in range(order + 1)
                      for i in range(order + 1 - j)])
    np.testing.assert_allclose(model.params(x, y).ravel(), q @ basis,
                               rtol=0, atol=1e-12)
    assert np.array_equal(model.params(x, y), want.params(x, y))


def test_draw_reproduces_bandlimited_model(tmp_path):
    """A spatially constant Gaussian PixelGrid drawn by the port reproduces
    the analytic Gaussian to the kernel accuracy, as the JAX draw does."""
    size, sigma = 33, 3.0
    grid = _gauss_grid(size, sigma)
    fname = str(tmp_path / "ffov_7.piff")
    piffutils.write_piff_file(fname, grid.ravel()[:, None], size, order=0, scale=1.0)
    model = piffutils.PiffPSFModel(fname, sca=1)

    ov = 4
    stamp = model.draw(100.0, 200.0, stamp_size=size - 4, oversamp=ov, device=CPU)
    ns = stamp.shape[0]
    c = (ns - 1) / 2.0
    y, x = np.mgrid[0:ns, 0:ns]
    want = np.exp(-0.5 * (((x - c) / ov) ** 2 + ((y - c) / ov) ** 2)
                  / sigma ** 2)
    want = want / (2 * np.pi * sigma ** 2) / ov ** 2
    assert np.abs(stamp - want).max() < 1e-5 * want.max()
    assert abs(stamp.sum() - 1.0) < 1e-3
    _within_f32(stamp, ref.PiffPSFModel(fname, sca=1).draw(
        100.0, 200.0, stamp_size=size - 4, oversamp=ov), 1)


def test_per_chip_solutions(tmp_path):
    size = 9
    g1 = _gauss_grid(size, 1.5).ravel()[:, None]
    g2 = 2.0 * g1
    fname = str(tmp_path / "ffov_2.piff")
    piffutils.write_piff_file(fname, {0: g1, 4: g2}, size, order=0)
    m1 = piffutils.PiffPSFModel(fname, sca=1)
    m5 = piffutils.PiffPSFModel(fname, sca=5)
    np.testing.assert_allclose(2.0 * m1.params(10, 10), m5.params(10, 10),
                               rtol=0, atol=1e-12)
    for sca, m in ((1, m1), (5, m5)):
        assert np.array_equal(m.q, ref.PiffPSFModel(fname, sca=sca).q)


def test_piff_to_legendre_constant_model(tmp_path):
    """A spatially constant model yields a cube whose only nonzero plane is
    the constant term, within 2 float32 spacings of the JAX cube."""
    size = 17
    grid = _gauss_grid(size, 2.0)
    fname = str(tmp_path / "ffov_3.piff")
    piffutils.write_piff_file(fname, grid.ravel()[:, None], size, order=0, scale=1.0)
    kw = dict(sca=1, stamp_size=size - 4, oversamp=2, legendre_order=1)
    cube = piffutils.piff_to_legendre(fname, device=CPU, **kw)
    assert cube.shape[0] == 4
    peak = np.abs(cube[0]).max()
    for k in [1, 2, 3]:
        assert np.abs(cube[k]).max() < 1e-6 * peak
    want = ref.piff_to_legendre(fname, **kw)
    assert np.abs(cube.astype(np.float64) - want).max() <= 2 * np.spacing(
        np.float32(np.abs(want[0]).max()))


@pytest.mark.parametrize("normbox", [None, 5], ids=["plain", "normbox"])
@pytest.mark.parametrize("order", [0, 2])
def test_draw_matches_reference(tmp_path, order, normbox):
    """At a few chip positions, off-centre stamps at an oversampling that
    is not the grid's: within 1 float32 spacing of max|stamp|."""
    fname, _q = _varying_model(tmp_path, order)
    got, want = piffutils.PiffPSFModel(fname, 7), ref.PiffPSFModel(fname, 7)
    for x, y in ((0.0, 0.0), (1234.5, 3001.25), (4087.0, 17.0)):
        kw = dict(stamp_size=14, oversamp=3, normbox=normbox)
        _within_f32(got.draw(x, y, device=CPU, **kw), want.draw(x, y, **kw), 1)


def test_batched_draw_equals_single_draws(tmp_path):
    """draw_models at S positions of one model, and over several models,
    gives each stamp exactly as draw gives it."""
    fname, _q = _varying_model(tmp_path, 2)
    other, _ = _varying_model(tmp_path, 1, seed=1)
    m, m2 = piffutils.PiffPSFModel(fname, 2), piffutils.PiffPSFModel(other, 2)
    rng = np.random.default_rng(3)
    xs, ys = rng.uniform(0, 4087, 5), rng.uniform(0, 4087, 5)
    kw = dict(stamp_size=10, oversamp=3, normbox=5, device=CPU)
    single = np.stack([m.draw(x, y, **kw) for x, y in zip(xs, ys)])
    assert np.array_equal(np.stack(piffutils.draw_models([m] * 5, xs, ys, **kw)), single)
    models = [m, m2, m, m2, m]
    mixed = piffutils.draw_models(models, xs, ys, **kw)
    for s, (mm, x, y) in enumerate(zip(models, xs, ys)):
        assert np.array_equal(mixed[s], mm.draw(x, y, **kw))


def test_piff_to_legendre_matches_reference(tmp_path):
    """A spatially varying order-2 model: the Legendre cube within 2
    float32 spacings of max|cube[0]| of the JAX cube."""
    fname, _q = _varying_model(tmp_path, 2)
    kw = dict(stamp_size=10, oversamp=3, legendre_order=2, normbox=5)
    got = piffutils.piff_to_legendre(fname, 4, device=CPU, **kw)
    want = ref.piff_to_legendre(fname, 4, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got.astype(np.float64) - want).max() <= 2 * np.spacing(
        np.float32(np.abs(want[0]).max()))


def test_piff_to_legendre_multi_matches_reference(tmp_path):
    """The L2_2506 file: the same HDUs and headers (OVSAMP among them), the
    placeholder cubes equal, the converted SCAs within 2 float32 spacings."""
    from pyimcom_tpu_torch.fitsio import fits_read

    fname, _q = _varying_model(tmp_path, 1)
    kw = dict(chips=[2, 5], stamp_size=8, oversamp=3, legendre_order=1)
    piffutils.piff_to_legendre_multi(fname, str(tmp_path / "port.fits"), device=CPU, **kw)
    ref.piff_to_legendre_multi(fname, str(tmp_path / "ref.fits"), **kw)
    got, want = fits_read(tmp_path / "port.fits"), fits_read(tmp_path / "ref.fits")
    assert len(got) == len(want) == 19
    assert got[0].header["OVSAMP"] == 3
    for g, w in zip(got, want):
        assert dict(g.header) == dict(w.header)
        a, b = np.asarray(g.data), np.asarray(w.data)
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.abs(a.astype(np.float64) - b).max() <= 2 * np.spacing(
            np.float32(np.abs(b[0]).max()))
    for sca in set(range(1, 19)) - {2, 5}:
        assert np.array_equal(got[sca].data, want[sca].data)


def test_psf_file_names_match_reference():
    """The PSF file broker: the Piff names of both packages; a format the
    JAX package rejects raises the same exception in the port."""
    from pyimcom_tpu.coadd import InImage as RefInImage
    from pyimcom_tpu_torch.coadd import InImage

    for fmt in ("piff", "PIFF", "piff:roman_psf", "L2_fits", "anlsim", "dc2_imsim"):
        assert InImage.psf_filename(fmt, 12) == RefInImage.psf_filename(fmt, 12)
    for fn in (InImage.psf_filename, RefInImage.psf_filename):
        with pytest.raises(ValueError, match="unknown PSF format"):
            fn("webbpsf", 3)


def test_cuda_draw_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the card's draw runs in chip_smoke.py")
    fname, _q = _varying_model(tmp_path, 0)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        piffutils.PiffPSFModel(fname, 1).draw(10.0, 10.0, stamp_size=4, oversamp=2)


@pytest.fixture(scope="module")
def piff_blocks(small_survey, tmp_path_factory):
    """The reference Block and the port's CPU Block at STOP 1 on the shared
    survey with INPSF [piff directory, "piff", 8]: each observation's PSF
    as tests/test_piff.py:115-127 writes it (order 0, the cube smeared by an
    8-sample tophat at spacing 1/8).  Both read the survey's layer cache.
    Returns (reference output, port output, port Block)."""
    from pyimcom_tpu.coadd import Block as RefBlock
    from survey_fixture_torch import write_piff_files
    from pyimcom_tpu_torch.coadd import Block

    piff_dir = tmp_path_factory.mktemp("piff")
    assert write_piff_files(small_survey["INPSF"][0], piff_dir, ov=8) == 8
    over = dict(INPSF=[str(piff_dir), "piff", 8])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYIMCOM_DEVICE_ASSEMBLY", "1")
        mp.setenv("PYIMCOM_NDEVICES", "1")
        cfg, out_ref = _cfg(small_survey, "_piff_ref", stop=1, **over)
        RefBlock(cfg=cfg, this_sub=1)
    cfg, out_port = _cfg(small_survey, "_piff_port", stop=1, **over)
    blk = Block(cfg=cfg, this_sub=1, device="cpu")
    return out_ref, out_port, blk


def test_piff_block_matches_reference(piff_blocks):
    out_ref, out_port, blk = piff_blocks
    assert blk.nrun == 1 and len(blk.stamp_stats) == 1
    times = blk.phase_times()
    assert times["psf.sample_group"]["calls"] >= 1
    assert times["psf.draw"]["calls"] == times["psf.sample_group"]["calls"]
    compare_outputs_f32(out_ref, out_port)


def test_piff_block_quality(piff_blocks):
    """The JAX test's criterion on the port's output: finite science and a
    U/C median below 1e-2 (NPIXPSF 16 truncates the PSF's wings)."""
    from pyimcom_tpu_torch.bench import uc_median
    from pyimcom_tpu_torch.fitsio import fits_read

    _out_ref, out_port, _blk = piff_blocks
    f = fits_read(out_port)
    assert np.all(np.isfinite(np.asarray(f[0].data)))
    uc = 10.0 ** (np.asarray(f["FIDELITY"].data, np.float64) / -5000.0)
    assert np.any((uc > 1e-10) & (uc < 0.5))
    assert uc_median(f) < 1e-2
