"""
The whole PSF-splitting iteration loop on pyimcom_tpu_torch, end to end: the
twin of tests/test_psfsplit_e2e.py::test_full_psfsplit_iteration, through
the port's entries on the CPU:

    splitpsf.main -> Block (iteration 0, short-range PSFs) ->
    imsubtract.main (wing subtraction from the coadd) ->
    update_cube.update -> Block (iteration 1) with the OLDCFG HDU.

Like its twin it is marked slow: the wing subtraction runs on 4088^2 SCAs
at the kernels' oversampling (a 24648^2 canvas a layer).  chip_smoke.py's
psfsplit_loop phase runs the same loop on the card with bin2x2.
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
