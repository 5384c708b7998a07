"""BASELINE.json config 3 as one run on the port, against the JAX package on
the CPU: Piff PSF files -> Legendre cubes -> PSF split -> the iteration-0
block, and the wing subtraction at the PSFs' own oversampling.

The run sits on the shared small_survey of test_torch_block.py.  Each
observation's PSF is written as a Piff file (survey_fixture_torch.
write_piff_files, order 1 with seeded u and v terms) and converted with
piff_to_legendre_multi at stamp 20, oversampling 6 and Legendre order 1:
the survey's own 120^2 x 4 cube shape.  Only the chip that the observation
places on the field is converted; the others are the conversion's
placeholders (a delta of 1/ov^2 in one ov x ov box).  Then:

* the port's Legendre files equal the JAX package's (headers, OVSAMP 6
  among them; the placeholders bit for bit, the converted chips within 2
  float32 spacings of max|cube[0]|);
* both packages' splitpsf.main, from the JAX package's Legendre files,
  write the same split files byte for byte, and the split files carry
  OVSAMP 6 (split_psf_to_fits copies it from the Legendre file's primary
  header) with every HDU finite, the placeholders' splits too;
* both packages' run_imsubtract take oversampling 6 from the split file,
  with no override;
* the wing subtraction with the converted chip's wing kernels at
  oversampling 6, on test_torch_splitpsf.py's 48^2 geometry, within 2
  float32 spacings at max|cube| of the JAX function;
* the iteration-0 block (PSFSPLIT [3.0, 6.0, 0.01], STOP 1) against the
  reference Block (its device group engine) within compare_outputs_f32's
  bounds, with IMSBITER 0 in both.

The whole loop through iteration 1 at 4088^2 is the slow
test_torch_psfsplit_e2e.py::test_config3_piff_chain; chip_smoke.py's
psfsplit_loop runs it on the card.
"""

import glob
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from survey_fixture_torch import field_chips
from test_torch_block import _cfg, compare_outputs_f32, same_oldcfg, small_survey  # noqa: F401
from test_torch_splitpsf import blockwise_against_reference

torch.set_num_threads(1)

STAMP, OV, ORDER = 20, 6, 1
PSFSPLIT = [3.0, 6.0, 0.01]
PIFF_GRAD, PIFF_SEED = 1e-3, 3


@pytest.fixture(scope="module")
def config3(small_survey, tmp_path_factory):  # noqa: F811
    """Piff files, both packages' Legendre files, both packages' split files
    (from the JAX package's Legendre files), and the iteration-0 block of
    each package on the split files.  The blocks share a private layer
    cache whose cubes link to the shared survey's (read only here)."""
    import os

    from pyimcom_tpu.coadd import Block as RefBlock
    from pyimcom_tpu.config import Config as RefConfig
    from pyimcom_tpu.splitpsf import splitpsf as ref_split
    from pyimcom_tpu.utils import piffutils as ref_piff
    from survey_fixture_torch import write_piff_files
    from pyimcom_tpu_torch.coadd import Block
    from pyimcom_tpu_torch.config import Config
    from pyimcom_tpu_torch.splitpsf import splitpsf
    from pyimcom_tpu_torch.utils import piffutils

    root = tmp_path_factory.mktemp("config3")
    out = {"root": root, "chips": field_chips(small_survey)}
    (root / "piff").mkdir()
    assert write_piff_files(small_survey["INPSF"][0], root / "piff", ov=OV, order=ORDER,
                            grad=PIFF_GRAD, seed=PIFF_SEED) == 8
    kw = dict(stamp_size=STAMP, oversamp=OV, legendre_order=ORDER)
    for name, convert, extra in (("leg_ref", ref_piff.piff_to_legendre_multi, {}),
                                 ("leg_port", piffutils.piff_to_legendre_multi,
                                  {"device": "cpu"})):
        (root / name).mkdir()
        for obsid, chips in out["chips"].items():
            convert(str(root / "piff" / f"ffov_{obsid:d}.piff"),
                    str(root / name / f"psf_polyfit_{obsid:d}.fits"), chips=chips, **kw,
                    **extra)

    # a private cache: the shared survey's layer cubes linked, the split
    # files of each package under its own cache root
    shared = small_survey["INLAYERCACHE"]
    for name in ("ref", "port"):
        (root / name).mkdir()
        for path in sorted(glob.glob(shared + "_*_*.fits")):
            os.symlink(path, str(root / name / "in") + path[len(shared):])
    d = dict(small_survey, INPSF=[str(root / "leg_ref"), "L2_2506", OV], PSFSPLIT=PSFSPLIT)
    out["cfg"] = {name: dict(d, INLAYERCACHE=str(root / name / "in")) for name in ("ref", "port")}
    out["count"] = {"ref": ref_split.main(RefConfig(dict(out["cfg"]["ref"]))),
                    "port": splitpsf.main(Config(dict(out["cfg"]["port"])))}

    # iteration 0, both packages on the port's split files
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYIMCOM_DEVICE_ASSEMBLY", "1")
        mp.setenv("PYIMCOM_NDEVICES", "1")
        cfg, out["out_ref"] = _cfg(out["cfg"]["port"], "_c3_ref", stop=1)
        RefBlock(cfg=cfg, this_sub=1)
    cfg, out["out_port"] = _cfg(out["cfg"]["port"], "_c3_port", stop=1)
    out["block"] = Block(cfg=cfg, this_sub=1, device="cpu")
    return out


def _split_file(config3, name, obsid):
    return str(config3["root"] / name / "in.psf" / f"psf_{obsid:d}.fits")


def test_legendre_files_match_reference(config3):
    """The port's L2_2506 files against the JAX package's: equal headers
    (OVSAMP 6), the placeholders equal, the converted chips within 2
    float32 spacings of max|cube[0]|, every cube 120^2 x 4."""
    from pyimcom_tpu_torch.fitsio import fits_read

    root = config3["root"]
    for obsid, chips in config3["chips"].items():
        got = fits_read(root / "leg_port" / f"psf_polyfit_{obsid:d}.fits")
        want = fits_read(root / "leg_ref" / f"psf_polyfit_{obsid:d}.fits")
        assert got[0].header["OVSAMP"] == want[0].header["OVSAMP"] == OV
        for sca, (g, w) in enumerate(zip(got, want)):
            assert dict(g.header) == dict(w.header)
            if sca == 0:
                continue
            a, b = np.asarray(g.data), np.asarray(w.data)
            assert a.shape == b.shape == ((ORDER + 1) ** 2, STAMP * OV, STAMP * OV)
            if sca in chips:
                assert np.abs(a.astype(np.float64) - b).max() <= 2 * np.spacing(
                    np.float32(np.abs(b[0]).max()))
            else:
                assert np.array_equal(a, b)


def test_split_files_match_reference_and_carry_ovsamp(config3):
    """splitpsf.main of both packages on the JAX package's Legendre files:
    one split file an in-filter observation, byte for byte; OVSAMP 6 in
    the primary header; every HDU finite, the split placeholders (the
    chips not converted) as well as the converted chips."""
    from pyimcom_tpu_torch.fitsio import fits_read

    assert config3["count"]["port"] == config3["count"]["ref"] >= 4
    files = sorted(glob.glob(str(config3["root"] / "port" / "in.psf" / "psf_*.fits")))
    assert len(files) == config3["count"]["port"]
    for path in files:
        obsid = int(re.search(r"psf_(\d+)\.fits$", path).group(1))
        assert Path(path).read_bytes() == Path(_split_file(config3, "ref", obsid)).read_bytes()
        f = fits_read(path)
        nsca = int(f[0].header["NSCA"])
        assert f[0].header["OVSAMP"] == OV and len(f) == 1 + 3 * nsca
        placeholders = set(range(1, nsca + 1)) - set(config3["chips"][obsid])
        assert placeholders
        for i in range(1, len(f)):
            assert np.all(np.isfinite(np.asarray(f[i].data))), (path, i)


def test_imsubtract_takes_the_split_files_oversampling(config3, monkeypatch, tmp_path):
    """run_imsubtract of both packages on an exposure of the run, with its
    split file and no oversampling given: the wing subtraction is called
    at oversampling 6 (OVSAMP), with the file's kernels for the exposure's
    SCA (the subtraction itself is stubbed to record its arguments)."""
    from pyimcom_tpu.config import Config as RefConfig
    from pyimcom_tpu.splitpsf import imsubtract as ref_imsub
    from pyimcom_tpu_torch.config import Config
    from pyimcom_tpu_torch.fitsio import fits_read
    from pyimcom_tpu_torch.splitpsf import imsubtract

    obsid = min(config3["chips"])
    sca = config3["chips"][obsid][0]
    split = _split_file(config3, "port", obsid)
    f = fits_read(split)
    K_file = np.asarray(f[int(f[0].header["KERSKIP"]) + sca].data, np.float64)
    seen = {}
    for name, mod, cfg_cls in (("ref", ref_imsub, RefConfig), ("port", imsubtract, Config)):
        def record(cube, ewcs, K, ov, *a, name=name, **kw):
            seen[name] = (K, ov)
            return cube

        monkeypatch.setattr(mod, "subtract_wings_blockwise", record)
        cfg = cfg_cls(dict(config3["cfg"]["port"], OUT=config3["out_port"][:-11]))
        mod.run_imsubtract(cfg, (obsid, sca), split, out_file=str(tmp_path / f"{name}.fits"))
    for K, ov in seen.values():
        assert ov == OV
        assert np.array_equal(K, K_file)


def test_wing_subtraction_at_the_psfs_oversampling_matches_reference(config3):
    """The converted chip's wing kernels, read from the port's split file
    with no oversampling given (imsubtract.wing_kernels: OVSAMP 6), through
    test_torch_splitpsf.py's 48^2 blockwise subtraction: the port within 2
    float32 spacings at max|cube| of the JAX function."""
    from pyimcom_tpu_torch.splitpsf import imsubtract

    obsid = min(config3["chips"])
    K, ov = imsubtract.wing_kernels(_split_file(config3, "port", obsid),
                                    config3["chips"][obsid][0])
    assert ov == OV and K.shape[0] == (ORDER + 1) ** 2
    blockwise_against_reference(K, ov)


def test_iteration0_block_matches_reference(config3):
    """The iteration-0 block on the split Piff PSFs at STOP 1: the port's
    CPU Block within compare_outputs_f32's bounds of the reference Block,
    OLDCFG with IMSBITER 0 in both, finite science."""
    from pyimcom_tpu_torch.fitsio import fits_read

    blk = config3["block"]
    assert blk.nrun == 1 and len(blk.stamp_stats) == 1
    compare_outputs_f32(config3["out_ref"], config3["out_port"])
    assert same_oldcfg(config3["out_ref"], config3["out_port"]) == 0
    assert np.all(np.isfinite(np.asarray(fits_read(config3["out_port"])[0].data)))
