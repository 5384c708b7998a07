"""The padded 2x2 mosaic on the port: pyimcom_tpu_torch.coadd.Block's
postage-pad path and pyimcom_tpu_torch.analysis.Mosaic's halo exchange
against the JAX package's, on the CPU.

The survey is that of the reference's own seam test
(tests/test_mosaic_seams.py): build_survey(n_obs=6, whitenoise1) with
NPIXPSF 12, INPAD 0.25, OUTSIZE [2, 16, 0.04], PAD 2, PADSIDES "auto", every
block at STOP 0.  The reference runs its host solve path
(PYIMCOM_DEVICE_ASSEMBLY=0), as that test does; both packages write the
same white-noise layer cache (one seed).  Bounds:

* the pad geometry (sides, stamp ranges, stamp count, the input stamps
  marked in use) is equal;
* a padded block is held to the reference's at compare_outputs_f32's
  bounds (tests/test_torch_block.py: science to 1e-8 of scale or one
  float32 ulp, maps 1 LSB, INWEIGHT 1e-8): the corner blocks (0, 0) and
  (1, 1), which pad B + L and T + R, and the first two groups of block
  (0, 0) with PADSIDES "all", PAD 1 (the chain's setting);
* an odd stamp span raises the reference's ValueError;
* the port's exchange of the reference's four block files equals the JAX
  exchange of the same files bit for bit, in every HDU, as saved;
* the port's own four blocks after its exchange pass the seam assertions
  of test_four_block_mosaic_halo_exchange (atol 1e-6 of scale).

The survey and each package's four blocks are built once per session
under file locks; tests/test_torch_runner.py's --share-pads case reads the
port's (port_mosaic).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from test_torch_block import compare_outputs_f32

torch.set_num_threads(1)

SEAM = {"NPIXPSF": 12, "INPAD": 0.25, "OUTSIZE": [2, 16, 0.04], "PAD": 2,
        "PADSIDES": "auto", "STOP": 0}


def _blocks(cfg_dict, suffix, subs, port):
    """Coadd blocks `subs` of `cfg_dict` with OUT + suffix by the port's CPU
    Block or the reference's host solve path; returns the output stem."""
    d = dict(cfg_dict, OUT=cfg_dict["OUT"] + suffix)
    if port:
        from pyimcom_tpu_torch.coadd import Block
        from pyimcom_tpu_torch.config import Config

        for sub in subs:
            Block(cfg=Config(dict(d)), this_sub=sub, device="cpu")
        return d["OUT"]
    from pyimcom_tpu.coadd import Block
    from pyimcom_tpu.config import Config

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYIMCOM_DEVICE_ASSEMBLY", "0")
        for sub in subs:
            Block(cfg=Config(dict(d)), this_sub=sub)
    return d["OUT"]


def _shared(tmp_path_factory, name, make):
    """make()'s JSON-able result, made once for the session: pytest-xdist
    workers share the session root, and a file lock per `name` lets one of
    them make it while the others wait."""
    from filelock import FileLock

    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent                  # the session root, not the worker's
    root = base / "torch_mosaic"
    with FileLock(str(root) + f".{name}.lock"):
        done = root / f"{name}.json"
        if done.exists():
            return json.loads(done.read_text())
        out = make(root)
        done.write_text(json.dumps(out))
        return out


def _survey(tmp_path_factory):
    from survey_fixture import build_survey

    return _shared(tmp_path_factory, "survey", lambda root: build_survey(
        root, n_obs=6, extrainput=["whitenoise1"], config_overrides=SEAM))


@pytest.fixture(scope="module")
def port_mosaic(tmp_path_factory):
    """The seam survey and the port's four blocks: {"cfg": the survey's
    configuration, "port": the output stem}."""
    cfg = _survey(tmp_path_factory)
    return {"cfg": cfg, "port": _shared(tmp_path_factory, "port", lambda root: _blocks(
        cfg, "_port", range(4), port=True))}


@pytest.fixture(scope="module")
def mosaic(port_mosaic, tmp_path_factory):
    """port_mosaic and the reference's four blocks ("ref": the output stem)."""
    cfg = port_mosaic["cfg"]
    return dict(port_mosaic, ref=_shared(tmp_path_factory, "ref", lambda root: _blocks(
        cfg, "_ref", range(4), port=False)))


def block_path(stem, sub):
    return f"{stem}_{sub // 2:02d}_{sub % 2:02d}.fits"


def copy_blocks(stem, dest):
    """Copy the four block files of `stem` to the stem `dest`; returns dest."""
    for sub in range(4):
        shutil.copy(block_path(stem, sub), block_path(dest, sub))
    return dest


def assert_same_files(path_a, path_b):
    """Two FITS files hold the same HDUs, names, headers and data, bit for bit."""
    from pyimcom_tpu_torch.fitsio import fits_read

    a, b = fits_read(path_a), fits_read(path_b)
    assert [h.name for h in a] == [h.name for h in b]
    for ha, hb in zip(a, b):
        assert dict(ha.header) == dict(hb.header), ha.name
        if isinstance(ha.data, dict):
            assert list(ha.data) == list(hb.data), ha.name
            for col in ha.data:
                x, y = np.asarray(ha.data[col]), np.asarray(hb.data[col])
                assert x.dtype == y.dtype and np.array_equal(x, y), (ha.name, col)
        else:
            x, y = np.asarray(ha.data), np.asarray(hb.data)
            assert x.dtype == y.dtype and np.array_equal(x, y), ha.name


# PADSIDES "all" with PAD 1 is coadded for its first two groups (the
# corner group of pad stamps and the next one along the bottom pad row)
PAD_CASES = {"auto-BL": (0, {}), "auto-TR": (3, {}),
             "all-pad1": (0, {"PAD": 1, "PADSIDES": "all", "STOP": 8})}


@pytest.mark.parametrize("case", list(PAD_CASES))
def test_pad_geometry_matches_reference(mosaic, case):
    """Block._handle_postage_pad: the padded sides, the stamp ranges, the
    stamp count and the input stamps marked in use equal the reference's."""
    from pyimcom_tpu.coadd import Block as RefBlock
    from pyimcom_tpu.config import Config as RefConfig
    from pyimcom_tpu_torch.coadd import Block
    from pyimcom_tpu_torch.config import Config

    sub, over = PAD_CASES[case]
    d = dict(mosaic["cfg"], **over)
    want = RefBlock(cfg=RefConfig(dict(d)), this_sub=sub, run_coadd=False)
    got = Block(cfg=Config(dict(d)), this_sub=sub, run_coadd=False, device="cpu")
    for blk in (want, got):
        blk.parse_config()
        blk._handle_postage_pad()
    assert got.pad_sides == want.pad_sides == {"auto-BL": "BL", "auto-TR": "TR",
                                               "all-pad1": "BTLR"}[case]
    for key in ("j_st_min", "j_st_max", "i_st_min", "i_st_max", "nrun"):
        assert getattr(got, key) == getattr(want, key), key
    np.testing.assert_array_equal(got.use_instamps, want.use_instamps)


@pytest.mark.parametrize("case", list(PAD_CASES))
def test_padded_block_matches_reference(mosaic, case):
    """The port's padded block against the reference's at
    compare_outputs_f32's bounds; the corner blocks come from the shared
    mosaic, PADSIDES "all" with PAD 1 is coadded here (STOP 8)."""
    sub, over = PAD_CASES[case]
    if over:
        cfg = dict(mosaic["cfg"], **over)
        ref = _blocks(cfg, "_ref_" + case, [sub], port=False)
        port = _blocks(cfg, "_port_" + case, [sub], port=True)
    else:
        ref, port = mosaic["ref"], mosaic["port"]
    compare_outputs_f32(block_path(ref, sub), block_path(port, sub))

    from pyimcom_tpu_torch.fitsio import fits_read

    sci = np.asarray(fits_read(block_path(port, sub))[0].data)
    assert np.all(np.isfinite(sci)) and np.abs(sci[0, 1]).max() > 0


def test_odd_stamp_span_raises(mosaic):
    """PAD 1 on the padded sides of an "auto" corner block gives an odd
    stamp span (n1 + 1 = 3); both packages refuse it."""
    cfg = dict(mosaic["cfg"], PAD=1)
    for port in (False, True):
        with pytest.raises(ValueError, match="Stamp span must be even"):
            _blocks(cfg, "_odd", [0], port=port)


def test_exchange_of_reference_blocks_matches_jax(mosaic, tmp_path):
    """analysis.Mosaic.share_padding_stamps of the port and of the JAX
    package on copies of the reference's four block files, each image saved:
    the files are equal bit for bit."""
    from pyimcom_tpu.analysis import Mosaic as RefMosaic
    from pyimcom_tpu_torch.analysis import Mosaic
    from pyimcom_tpu_torch.fitsio import fits_read

    stems = {}
    for name, cls in (("jax", RefMosaic), ("port", Mosaic)):
        stems[name] = copy_blocks(mosaic["ref"], str(tmp_path / name))
        mos = cls(stems[name])
        mos.share_padding_stamps()
        assert len(mos.images) == 4
        for oi in mos.images.values():
            oi.save()
    for sub in range(4):
        assert_same_files(block_path(stems["jax"], sub), block_path(stems["port"], sub))
        # the exchange changed every block
        assert not np.array_equal(fits_read(block_path(stems["port"], sub))[0].data,
                                  fits_read(block_path(mosaic["ref"], sub))[0].data)


def test_four_block_mosaic_halo_exchange(mosaic):
    """The port's twin of tests/test_mosaic_seams.py: the port's four blocks
    and the port's exchange, with the seam assertions of the reference test
    (the noise layer, atol 1e-6 of scale)."""
    from pyimcom_tpu_torch.analysis import Mosaic

    mos = Mosaic(mosaic["port"])
    assert mos.nblock == 2
    cfg = mos.cfg
    w = cfg.postage_pad * cfg.n2
    NsideP, Nside = cfg.NsideP, cfg.Nside

    LYR = 1
    a_before = np.array(mos[0, 0].load()[0].data[0, LYR], np.float64)
    assert np.any(a_before != 0), "mosaic produced an empty noise layer"

    mos.share_padding_stamps()

    A = np.array(mos[0, 0].load()[0].data[0, LYR], np.float64)   # left block
    B = np.array(mos[1, 0].load()[0].data[0, LYR], np.float64)   # right block
    C = np.array(mos[0, 1].load()[0].data[0, LYR], np.float64)   # top neighbor

    fk = cfg.fade_kernel
    assert np.all(a_before[:, NsideP - w + fk:] == 0), \
        "auto mode: interior pad must start empty"
    assert not np.allclose(A[:, NsideP - w:], a_before[:, NsideP - w:])

    core = np.s_[w + fk:NsideP - w - fk]
    for c in range(NsideP - w + fk, NsideP):
        ca = A[core, c]
        cb = B[core, c - Nside]
        scale = max(np.abs(cb).max(), 1e-12)
        np.testing.assert_allclose(ca, cb, rtol=0, atol=1e-6 * scale,
                                   err_msg=f"x-seam mismatch at column {c}")
        assert np.any(cb != 0)

    for r in range(NsideP - w + fk, NsideP):
        ra = A[r, core]
        rc = C[r - Nside, core]
        scale = max(np.abs(rc).max(), 1e-12)
        np.testing.assert_allclose(ra, rc, rtol=0, atol=1e-6 * scale,
                                   err_msg=f"y-seam mismatch at row {r}")

    iwA = np.array(mos[0, 0].load()["INWEIGHT"].data)
    iwB = np.array(mos[1, 0].load()["INWEIGHT"].data)
    idsA = list(zip(mos[0, 0].load()["INDATA"]["obsid"], mos[0, 0].load()["INDATA"]["sca"]))
    idsB = list(zip(mos[1, 0].load()["INDATA"]["obsid"], mos[1, 0].load()["INDATA"]["sca"]))
    shared = set(idsA) & set(idsB)
    assert shared
    n1P, pad = cfg.n1P, cfg.postage_pad
    rows = np.s_[pad:n1P - pad]   # corner pad stamps mix two neighbors
    for idsca in shared:
        mi, ui = idsA.index(idsca), idsB.index(idsca)
        np.testing.assert_allclose(
            iwA[:, mi, rows, n1P - pad:], iwB[:, ui, rows, pad:2 * pad],
            rtol=0, atol=1e-7)
