"""The slice as a whole: pyimcom_tpu_torch.coadd.Block against the JAX
package's Block on the CPU.

Both run the reduced small_survey of tests/test_device_assembly.py (n_obs 8,
cstar14, NPIXPSF 16, INPAD 0.3, FLATPEN 1e-7) for one full 2x2 group
(STOP 4); the reference runs its device group engine
(PYIMCOM_DEVICE_ASSEMBLY=1) on one device.  The outputs are compared as
test_device_assembly._compare_outputs does: the science cube to 1e-8 of its
scale, the quantized maps to 1 LSB, INWEIGHT to 1e-8.  The port reads the
input-layer cache that the reference run wrote, so star injection (tested in
test_torch_layer.py) is paid once.
"""

import numpy as np
import pytest
import torch

from test_device_assembly import _compare_outputs

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def small_survey(tmp_path_factory):
    from survey_fixture import build_survey

    tmp = tmp_path_factory.mktemp("torchblk")
    return build_survey(tmp, n_obs=8, extrainput=["cstar14"],
                        config_overrides={"NPIXPSF": 16, "INPAD": 0.3,
                                          "FLATPEN": 1e-7})


def _cfg(cfg_dict, suffix, **over):
    from pyimcom_tpu.config import Config

    d = dict(cfg_dict, STOP=4, **over)
    d["OUT"] = d["OUT"] + suffix
    return Config(d), d["OUT"] + "_00_01.fits"


def test_block_matches_reference(small_survey, monkeypatch):
    from pyimcom_tpu.coadd import Block as RefBlock
    from pyimcom_tpu_torch.coadd import Block
    from pyimcom_tpu_torch.ops import interp_cuda

    monkeypatch.setenv("PYIMCOM_DEVICE_ASSEMBLY", "1")
    monkeypatch.setenv("PYIMCOM_NDEVICES", "1")
    cfg, out_ref = _cfg(small_survey, "_ref")
    RefBlock(cfg=cfg, this_sub=1)

    interp_cuda.reset_launch_counts()
    cfg, out_port = _cfg(small_survey, "_port")
    blk = Block(cfg=cfg, this_sub=1, device="cpu")
    # on the CPU every interpolation takes the kernels' plain versions
    assert interp_cuda.launches == {"interp_d5512_dense": 0,
                                    "sweep_d5512_scatter": 0}
    times = blk.phase_times()
    assert times["stamp.sweep"]["calls"] == 1
    assert times["stamp.sweep"]["device_ms"] is None
    _compare_outputs(out_ref, out_port, atol_sci=1e-8)

    from pyimcom_tpu.fitsio import fits_read

    sci = np.asarray(fits_read(out_port)[0].data)
    assert np.all(np.isfinite(sci)) and np.abs(sci).max() > 0


@pytest.mark.parametrize("over", [{"LAKERNEL": "Eigen"},
                                  {"KAPPAC": [1e-4, 1e-3]},
                                  {"PSFINTERP": "G4460"}],
                         ids=["eigen", "multi-kappa", "G4460"])
def test_configs_outside_the_slice_raise(small_survey, over):
    from pyimcom_tpu_torch.coadd import Block

    cfg, _ = _cfg(small_survey, "_never", **over)
    with pytest.raises(NotImplementedError):
        Block(cfg=cfg, this_sub=1, device="cpu")


def test_cuda_block_without_gpu_raises(small_survey):
    from pyimcom_tpu_torch.coadd import Block

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA block runs in chip_smoke.py")
    cfg, _ = _cfg(small_survey, "_never")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        Block(cfg=cfg, this_sub=1)
