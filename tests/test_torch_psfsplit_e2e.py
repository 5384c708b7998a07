"""
The whole PSF-splitting iteration loop on pyimcom_tpu_torch, end to end: the
twin of tests/test_psfsplit_e2e.py::test_full_psfsplit_iteration, through
the port's entries on the CPU:

    splitpsf.main -> Block (iteration 0, short-range PSFs) ->
    imsubtract.main (wing subtraction from the coadd) ->
    update_cube.update -> Block (iteration 1) with the OLDCFG HDU.

Like its twin it is marked slow: the wing subtraction runs on 4088^2 SCAs
at the kernels' oversampling.  test_config3_piff_chain runs BASELINE.json
config 3 as one chain: the survey's PSFs as Piff files, converted to
Legendre cubes (piff_to_legendre_multi: stamp 20, oversampling 6, order 1),
split, and the loop through iteration 1 with bin2x2 (a 12324^2 canvas a
layer at the split files' OVSAMP 6), held to tests/test_full_pipeline.py's
criteria, with SL1 about the value for a pixel response counted twice
(the Legendre cubes converted from the Piff files hold the pixel, which
the split applies again: a fault both packages share).  chip_smoke.py's psfsplit_loop phase runs that chain on the card.
"""

import glob
import json
import re

import numpy as np
import pytest
import torch

from survey_fixture_torch import build_survey

torch.set_num_threads(1)


@pytest.mark.slow
def test_full_psfsplit_iteration(tmp_path):
    from pyimcom_tpu_torch.coadd import Block
    from pyimcom_tpu_torch.config import Config
    from pyimcom_tpu_torch.fitsio import fits_read
    from pyimcom_tpu_torch.splitpsf import imsubtract, splitpsf
    from pyimcom_tpu_torch.splitpsf.update_cube import get_iteration, update

    cfg_dict = build_survey(tmp_path, n_obs=8, extrainput=["cstar14"],
                            config_overrides={"NPIXPSF": 16, "INPAD": 0.4})
    cache = str(tmp_path / "cache" / "in")
    d = dict(cfg_dict, INLAYERCACHE=cache, PSFSPLIT=[3.0, 6.0, 0.01], STOP=1)
    cfgfile = str(tmp_path / "cfg_split.json")
    with open(cfgfile, "w") as f:
        json.dump(d, f)

    # --- stage 0: split every in-filter observation's PSF ----------------
    assert splitpsf.main(cfgfile) >= 4
    sf = fits_read(cache + f".psf/psf_{0:d}.fits")
    nsca = int(sf[0].header["NSCA"])
    assert sf[0].header["GSSKIP"] == nsca
    assert sf[0].header["KERSKIP"] == 2 * nsca

    # --- stage 1: iteration-0 coadd with the short-range PSF -------------
    d0 = dict(d, OUT=d["OUT"] + "_it0")
    Block(cfg=Config(d0), this_sub=1, device="cpu")
    out0 = fits_read(d0["OUT"] + "_00_01.fits")
    assert out0["OLDCFG"].header["IMSBITER"] == 0

    # --- stage 2: wing subtraction per SCA --------------------------------
    cfg0 = Config(d0)
    pat = re.compile(r"_(\d{8})_(\d{2})\.fits$")
    scas = sorted({int(pat.search(p).group(2))
                   for p in glob.glob(cache + "_*_*.fits") if pat.search(p)})
    assert scas, "iteration-0 run must have populated the input-layer cache"
    wrote = []
    for sca in scas:
        wrote += imsubtract.main(cfg0, sca, device="cpu")
    assert wrote, "wing subtraction produced no _subI files"
    a = np.asarray(fits_read(wrote[0].replace("_subI", ""))[0].data, np.float64)
    b = np.asarray(fits_read(wrote[0])[0].data, np.float64)
    assert a.shape == b.shape
    diff = np.abs(a - b)
    assert diff.max() > 0, "subtraction changed nothing"
    assert np.median(diff[np.isfinite(diff)]) < 0.5 * np.abs(a).max()

    # --- stage 3: swap the cache, advance the iteration ------------------
    assert update(Config(cfgfile)) == 1 and get_iteration(cache) == 1

    # --- stage 4: iteration-1 coadd ---------------------------------------
    d1 = dict(d, OUT=d["OUT"] + "_it1")
    Block(cfg=Config(d1), this_sub=1, device="cpu")
    out1 = fits_read(d1["OUT"] + "_00_01.fits")
    assert out1["OLDCFG"].header["IMSBITER"] == 1
    hist = json.loads("".join(str(r) for r in out1["OLDCFG"].data["text"]))
    assert hist[0]["iteration"] == 0
    for out in (out0, out1):
        assert np.all(np.isfinite(np.asarray(out[0].data, np.float64)))


@pytest.mark.slow
def test_config3_piff_chain(tmp_path):
    """Piff -> Legendre -> split -> iteration 0 -> wing subtraction (every
    SCA's task, the oversampling from the split files) -> update ->
    iteration 1, the whole block 1: OVSAMP 6 in the split files, IMSBITER 0
    then 1, the star's SL1 within 5e-3 (tests/test_full_pipeline.py:165's
    bound) of survey_fixture_torch.pixel_twice_sl1 (the pixel response in
    the Piff model and again in the split, a fault both packages share)
    and its VAR no worse than 5 % above iteration 0's (:166), U/C medians
    below 1e-6 and finite maps in both iterations."""
    from survey_fixture_torch import field_chips, pixel_twice_sl1, write_piff_files
    from pyimcom_tpu_torch.bench import uc_median
    from pyimcom_tpu_torch.coadd import Block
    from pyimcom_tpu_torch.config import Config
    from pyimcom_tpu_torch.fitsio import fits_read
    from pyimcom_tpu_torch.pipeline import star_quality
    from pyimcom_tpu_torch.splitpsf import imsubtract, splitpsf
    from pyimcom_tpu_torch.splitpsf.update_cube import update
    from pyimcom_tpu_torch.utils import piffutils

    cfg_dict = build_survey(tmp_path, n_obs=8, extrainput=["cstar14"],
                            config_overrides={"NPIXPSF": 16, "INPAD": 0.4})
    (tmp_path / "piff").mkdir()
    (tmp_path / "leg").mkdir()
    assert write_piff_files(cfg_dict["INPSF"][0], tmp_path / "piff", ov=6, order=1,
                            grad=1e-3, seed=3) == 8
    for obsid, chips in field_chips(cfg_dict).items():
        piffutils.piff_to_legendre_multi(
            str(tmp_path / "piff" / f"ffov_{obsid:d}.piff"),
            str(tmp_path / "leg" / f"psf_polyfit_{obsid:d}.fits"), chips=chips,
            stamp_size=20, oversamp=6, legendre_order=1, device="cpu")
    cache = str(tmp_path / "cache" / "in")
    d = dict(cfg_dict, INLAYERCACHE=cache, INPSF=[str(tmp_path / "leg"), "L2_2506", 6],
             PSFSPLIT=[3.0, 6.0, 0.01, True], STOP=0)
    assert splitpsf.main(Config(dict(d))) >= 4
    assert all(fits_read(p)[0].header["OVSAMP"] == 6
               for p in glob.glob(cache + ".psf/psf_*.fits"))

    outs = {}
    for it, suffix in ((0, "_it0"), (1, "_it1")):
        if it == 1:
            pat = re.compile(r"_(\d{8})_(\d{2})\.fits$")
            scas = sorted({int(pat.search(p).group(2)) for p in glob.glob(cache + "_*_*.fits")
                           if pat.search(p)})
            wrote = sum((imsubtract.main(Config(dict(d, OUT=d["OUT"] + "_it0")), sca,
                                         device="cpu") for sca in scas), [])
            assert wrote
            assert update(Config(dict(d))) == 1
        d_it = dict(d, OUT=d["OUT"] + suffix)
        Block(cfg=Config(d_it), this_sub=1, device="cpu")
        outs[it] = d_it["OUT"] + "_00_01.fits"
        f = fits_read(outs[it])
        assert f["OLDCFG"].header["IMSBITER"] == it
        assert all(np.all(np.isfinite(np.asarray(h.data))) for h in f
                   if getattr(h, "data", None) is not None
                   and np.asarray(h.data).dtype.kind in "fiu")
        assert uc_median(f) < 1e-6
    (sl0, var0), (sl1, var1) = (star_quality(outs[it], d) for it in (0, 1))
    assert abs(sl0 - pixel_twice_sl1(d)) < 5e-3 and abs(sl1 - pixel_twice_sl1(d)) < 5e-3
    assert var1 < max(var0 * 1.05, 1e-5)
