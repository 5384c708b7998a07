"""Star and galaxy injection of pyimcom_tpu_torch.layer against the JAX
package's.

make_image_from_grid draws every HEALPix grid star whose patch touches a
small SCA patch, make_extobj_image_from_grid every grid galaxy (the PSF
convolved with a sheared Sersic profile); both packages get the same PSF
callable and WCS, and the images agree to 1e-12 of the peak (float64 on
the CPU).
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


class _Exposure:
    """The parts of an InImage that galaxy injection reads."""

    def __init__(self):
        from survey_fixture import CDEC, CRA, make_sca_wcs

        self.inwcs = make_sca_wcs(CRA, CDEC, 35.0, 5)

    @staticmethod
    def get_psf_pos(pos, use_drawpsf=False):
        return _psf_at(pos, use_drawpsf)


@pytest.mark.parametrize("morph", ["n=0.5,hlr=0.1,shape=0.2:0.1",
                                   "n=2.5,hlr=0.15,shape=0.1:-0.2,rot=30,shear=0.05:0.02,"
                                   "seed=7"],
                         ids=["gaussian", "sersic"])
def test_galaxy_injection_matches_reference(morph):
    args = ref.parse_gsext_args(morph.split(","))
    exposure = _Exposure()
    want = ref.make_extobj_image_from_grid(14, exposure, 200, 6, args)
    got = layer.make_extobj_image_from_grid(14, exposure, 200, 6, args,
                                            device=torch.device("cpu"))
    peak = np.abs(want).max()
    assert peak > 0 and np.count_nonzero(want) > 300   # several galaxies
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * peak)


def test_extended_objects_raise(tmp_path):
    """gsextchrom with a chromatic PSF directory that holds no cube raises
    FileNotFoundError, as the reference does."""
    class Blk:
        cfg = obsdata = device = None

    class Img:
        blk, idsca = Blk(), (0, 1)

    with pytest.raises(FileNotFoundError, match="chromatic PSF cube"):
        layer._build_extra_layer(f"gsextchrom14,{tmp_path},n=0.5", Img())
