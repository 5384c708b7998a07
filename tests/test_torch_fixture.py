"""The jax-free survey fixture twin builds the same survey as survey_fixture.

Both builders run for n_obs=4; the cfg.json files must be identical and
every written L2 image must agree to 1e-6 of the star's peak (the images
are float32 FITS, so the tolerance allows f32 rounding).
"""

import numpy as np
import torch

torch.set_num_threads(1)


def test_twin_fixture_matches_reference(tmp_path):
    import survey_fixture
    import survey_fixture_torch

    from pyimcom_tpu.fitsio import fits_read

    a, b = tmp_path / "jax", tmp_path / "torch"
    survey_fixture.build_survey(a, n_obs=4, extrainput=["cstar14"])
    survey_fixture_torch.build_survey(b, n_obs=4, extrainput=["cstar14"])

    cfg_a = (a / "cfg.json").read_text().replace(str(a), "$DIR")
    cfg_b = (b / "cfg.json").read_text().replace(str(b), "$DIR")
    assert cfg_a == cfg_b

    names = sorted(p.name for p in (a / "in").iterdir())
    assert names == sorted(p.name for p in (b / "in").iterdir())
    images = [n for n in names if not n.endswith("_mask.fits")]
    assert images
    for name in images:
        ia = np.asarray(fits_read(a / "in" / name)[0].data, np.float64)
        ib = np.asarray(fits_read(b / "in" / name)[0].data, np.float64)
        peak = np.abs(ia).max()
        assert peak > 0, name
        np.testing.assert_allclose(ib, ia, rtol=0, atol=1e-6 * peak, err_msg=name)
