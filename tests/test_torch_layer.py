"""Star injection of pyimcom_tpu_torch.layer against the JAX package's.

make_image_from_grid draws every HEALPix grid star whose patch touches a
small SCA patch; both packages get the same PSF callable and WCS, and the
images agree to 1e-12 of the peak (float64 on the CPU).
"""

import numpy as np
import pytest
import torch

from pyimcom_tpu import layer as ref
from pyimcom_tpu.ops.psfmodels import psf_gaussian
from pyimcom_tpu_torch import layer

torch.set_num_threads(1)


def _psf_at(pos, use_drawpsf=False):
    """A slightly position-dependent oversampled Gaussian PSF."""
    s = 5.0 + 0.5 * np.sin(np.radians(pos[0]) * 3e4)
    return psf_gaussian(64, s, s * 1.1)


def test_star_injection_matches_reference():
    from survey_fixture import CDEC, CRA, make_sca_wcs

    wcs = make_sca_wcs(CRA, CDEC, 35.0, 5)
    args = (14, _psf_at, (3, 5), None, wcs, 200, 6)
    want = ref.make_image_from_grid(*args)
    got = layer.make_image_from_grid(*args, device=torch.device("cpu"))
    peak = np.abs(want).max()
    assert peak > 0 and np.count_nonzero(want) > 300   # several stars
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * peak)


def test_extended_objects_raise():
    class Blk:
        cfg = obsdata = device = None

    class Img:
        blk, idsca = Blk(), (0, 1)

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        layer._build_extra_layer("gsext14,n=0.5", Img())
