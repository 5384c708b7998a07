"""The slice as a whole: pyimcom_tpu_torch.coadd.Block against the JAX
package's Block on the CPU.

Both run the reduced small_survey of tests/test_device_assembly.py (n_obs 8,
cstar14, NPIXPSF 16, INPAD 0.3, FLATPEN 1e-7) for one full 2x2 group
(STOP 4); the reference runs its device group engine
(PYIMCOM_DEVICE_ASSEMBLY=1) on one device, once for the session
(reference_block, which test_torch_bench.py shares).  The outputs are
compared as test_device_assembly._compare_outputs does: the science cube
to 1e-8 of its scale, the quantized maps to 1 LSB, INWEIGHT to 1e-8.  Both
read the input-layer cache that the reference's layer wrapper wrote when
the survey was built, so star injection (tested in test_torch_layer.py) is
paid once.

The other LAKERNELs are held against the reference in the same way by
:func:`port_vs_reference`, one solver family per test file.
"""

import json
import os

import numpy as np
import pytest
import torch

from test_device_assembly import _compare_outputs

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def small_survey(tmp_path_factory):
    """The reduced survey, built once for the whole session: the port's
    block tests of every solver family read it (each writes its own
    outputs), so pytest-xdist workers share one directory under the
    session's temporary root, and a file lock lets one of them build it.
    Under the same lock the reference's layer wrapper builds its input-layer
    cache, which every block on the survey then loads: built by the
    reference Block of whichever test came first, the same cubes were built
    several times at once by the workers."""
    from filelock import FileLock

    from pyimcom_tpu.layer_wrapper import build_all_layers
    from survey_fixture import build_survey

    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent                  # the session root, not the worker's
    root = base / "torch_small_survey"
    with FileLock(str(root) + ".lock"):
        if (root / "cfg.json").exists():
            return json.loads((root / "cfg.json").read_text())
        cfg = build_survey(root, n_obs=8, extrainput=["cstar14"],
                           config_overrides={"NPIXPSF": 16, "INPAD": 0.3,
                                             "FLATPEN": 1e-7})
        build_all_layers(cfg, nworkers=1)
        return cfg


@pytest.fixture(scope="module")
def reference_block(small_survey):
    """The reference's block 1 of the reduced survey at STOP 4 (bench.py's
    run_region: its device group engine on one device), made once for the
    session under a file lock; test_block_matches_reference and
    test_torch_bench.py hold the port's block and its bench entry to it.
    Returns its output path."""
    from filelock import FileLock

    import bench as ref_bench

    out = small_survey["OUT"] + "_ref_00_01.fits"
    with FileLock(out + ".lock"):
        if not os.path.exists(out):
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("PYIMCOM_DEVICE_ASSEMBLY", "1")
                mp.setenv("PYIMCOM_NDEVICES", "1")
                ref_bench.run_region(small_survey, stop=4, out_suffix="_ref")
    return out


def _cfg(cfg_dict, suffix, stop=4, **over):
    from pyimcom_tpu.config import Config

    d = dict(cfg_dict, STOP=stop, **over)
    d["OUT"] = d["OUT"] + suffix
    return Config(d), d["OUT"] + "_00_01.fits"


def compare_outputs_f32(out_a, out_b):
    """_compare_outputs at atol_sci=1e-8, except that a science value may
    also differ by one float32 ulp: the cube is stored in float32, whose
    ulp near the peak is ~4e-8 of scale, so two f64 pipelines that agree to
    ~1e-12 still round a few values to neighbouring floats."""
    from pyimcom_tpu.fitsio import fits_read

    a = np.asarray(fits_read(out_a)[0].data)
    b = np.asarray(fits_read(out_b)[0].data)
    assert a.dtype == b.dtype == np.float32
    off = np.abs(b.astype(np.float64) - a) > 1e-8 * np.abs(a).max()
    assert np.all(np.abs(b - a)[off] <= np.spacing(np.abs(a[off]))), \
        f"{np.count_nonzero(off)} science values beyond 1e-8 of scale and 1 ulp"
    # the maps (1 LSB) and INWEIGHT as _compare_outputs checks them; the
    # science cube is checked above
    _compare_outputs(out_a, out_b, atol_sci=np.inf)


def port_vs_reference(cfg_dict, monkeypatch, suffix, assembly, stop=2, **over):
    """Run the reference Block (PYIMCOM_DEVICE_ASSEMBLY=`assembly`: "1" its
    device group engine, "0" its host solve path) and the port's CPU Block
    on one configuration; compare the outputs (:func:`compare_outputs_f32`)
    and return the port's."""
    from pyimcom_tpu.coadd import Block as RefBlock
    from pyimcom_tpu_torch.coadd import Block

    monkeypatch.setenv("PYIMCOM_DEVICE_ASSEMBLY", assembly)
    monkeypatch.setenv("PYIMCOM_NDEVICES", "1")
    cfg, out_ref = _cfg(cfg_dict, suffix + "_ref", stop=stop, **over)
    RefBlock(cfg=cfg, this_sub=1)
    cfg, out_port = _cfg(cfg_dict, suffix + "_port", stop=stop, **over)
    Block(cfg=cfg, this_sub=1, device="cpu")
    compare_outputs_f32(out_ref, out_port)
    return out_port


def test_block_matches_reference(small_survey, reference_block):
    from pyimcom_tpu_torch.coadd import Block
    from pyimcom_tpu_torch.ops import interp_cuda

    out_ref = reference_block
    interp_cuda.reset_launch_counts()
    cfg, out_port = _cfg(small_survey, "_port")
    blk = Block(cfg=cfg, this_sub=1, device="cpu")
    # on the CPU every interpolation takes the kernels' plain versions
    assert interp_cuda.launches == {"interp_d5512_dense": 0,
                                    "sweep_d5512_scatter.pool": 0,
                                    "sweep_d5512_scatter.B": 0,
                                    "interp_g4460_dense": 0,
                                    "sweep_g4460_scatter.pool": 0,
                                    "sweep_g4460_scatter.B": 0}
    times = blk.phase_times()
    assert times["stamp.sweep"]["calls"] == 1
    assert times["stamp.sweep"]["device_ms"] is None
    _compare_outputs(out_ref, out_port, atol_sci=1e-8)

    from pyimcom_tpu.fitsio import fits_read

    sci = np.asarray(fits_read(out_port)[0].data)
    assert np.all(np.isfinite(sci)) and np.abs(sci).max() > 0


def split_psfs(cfg_dict):
    """Split the survey's PSFs for `cfg_dict` (which sets PSFSPLIT) into
    INLAYERCACHE.psf/ with the port's splitpsf.main, once a session (under
    a file lock: the block tests share the survey)."""
    from filelock import FileLock

    from pyimcom_tpu_torch.config import Config
    from pyimcom_tpu_torch.splitpsf import splitpsf

    target = cfg_dict["INLAYERCACHE"] + ".psf"
    with FileLock(target + ".lock"):
        if not os.path.exists(os.path.join(target, "done")):
            assert splitpsf.main(Config(dict(cfg_dict))) >= 4
            open(os.path.join(target, "done"), "w").close()


def same_oldcfg(out_a, out_b):
    """The OLDCFG HDUs of two PSFSPLIT blocks: the iteration and the
    history text, equal."""
    from pyimcom_tpu.fitsio import fits_read

    a, b = fits_read(out_a)["OLDCFG"], fits_read(out_b)["OLDCFG"]
    assert a.header["IMSBITER"] == b.header["IMSBITER"]
    assert [str(t) for t in a.data["text"]] == [str(t) for t in b.data["text"]]
    return int(a.header["IMSBITER"])


@pytest.mark.parametrize("over", [{"LAKERNEL": "Empirical", "EMPIRNQC": True},
                                  {"SOLVERPREC": "mixed"},
                                  {"PSFSPLIT": [6.0, 7.0, 1e-3]},
                                  {"PSFINTERP": "G4460"}],
                         ids=["empirnqc", "mixed", "psfsplit", "G4460"])
def test_configs_outside_the_slice_raise(small_survey, monkeypatch, over):
    """Every configuration that the port once refused is covered now.  Three
    cases hold the port's block to the reference's at STOP 2
    (compare_outputs_f32): Empirical without quality control (EMPIRNQC)
    against the reference's host solve path, its only path; PSFINTERP
    G4460 (K1 and K2 in their 8-tap forms, plain on the CPU) and an
    iteration-0 PSFSPLIT block (the short-range PSFs of the port's split
    files, the doubled overlap window, OLDCFG with IMSBITER 0) against its
    device group engine.  SOLVERPREC "mixed" (the float32 factorization with
    float64 refinement) holds the port's STOP-2 block to its float64 block
    at the bounds of tests/test_solvers.py::test_mixed_precision_matches_f64
    for a production-like node (U/C 1e-6, Sigma 1e-4; the survey's KAPPAC
    is 5e-4), on the decoded FIDELITY and SIGMA maps, and its science cube
    to compare_outputs_f32's bounds."""
    from pyimcom_tpu_torch.analysis import OutImage
    from pyimcom_tpu_torch.coadd import Block

    if "SOLVERPREC" in over:
        outs = {}
        for name, extra in (("mixed", over), ("f64", {})):
            cfg, outs[name] = _cfg(small_survey, "_prec_" + name, stop=2, **extra)
            Block(cfg=cfg, this_sub=1, device="cpu")
        compare_outputs_f32(outs["f64"], outs["mixed"])
        a, b = OutImage(outs["f64"]), OutImage(outs["mixed"])
        for name, bound in (("FIDELITY", 1e-6), ("SIGMA", 1e-4)):
            x, y = (np.asarray(o.get_output_map(name), np.float64) for o in (a, b))
            assert np.any(x > 0) and np.array_equal(x > 0, y > 0), name
            assert float(np.abs(x - y).max()) < bound, name
        return
    if over.get("EMPIRNQC"):
        port_vs_reference(small_survey, monkeypatch, "_empirnqc", "0", **over)
        return
    if "PSFINTERP" in over:
        port_vs_reference(small_survey, monkeypatch, "_g4460", "1", **over)
        return
    if "PSFSPLIT" in over:
        split_psfs(dict(small_survey, **over))
        out_port = port_vs_reference(small_survey, monkeypatch, "_psfsplit", "1", **over)
        assert same_oldcfg(out_port.replace("_port", "_ref"), out_port) == 0
        return
    raise AssertionError(f"no case for {over}")


def test_cuda_block_without_gpu_raises(small_survey):
    from pyimcom_tpu_torch.coadd import Block

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA block runs in chip_smoke.py")
    cfg, _ = _cfg(small_survey, "_never")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        Block(cfg=cfg, this_sub=1)
