"""Checkpoint and resume of pyimcom_tpu_torch.coadd.Block on the CPU.

The port's twin of tests/test_device_assembly.py::test_checkpoint_kill_and_resume:
the reduced survey of test_torch_block.py, all 16 stamps of block 1 (four
2x2 groups), snapshots after every drained group (checkpoint_sec=0), the
run killed after its 2nd snapshot, then resumed: it skips the 2 saved
groups in both passes, removes the snapshot when it finishes, and matches
the uninterrupted run within 1e-11 of the science cube's scale (the maps to
1 LSB, INWEIGHT to 1e-8, as _compare_outputs checks them).  The snapshot
holds the reference's keys, dtypes and maps (Block._CKPT_MAPS), and a
snapshot of another geometry is ignored with the reference's message.

The uninterrupted run is made once for the session (test_torch_budget.py
reads it too).  STOP 0 and not STOP 12: on this survey the second group's
submatrices are all consumed by its own stamps, so at STOP 12 one pool is
retained and no budget could evict it; four groups give both tests the
cross-row reuse.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from test_device_assembly import _compare_outputs
from test_torch_block import _cfg, small_survey  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def uninterrupted(small_survey):
    """The port's whole block 1 without checkpoints or budget, made once for
    the session (a file lock lets one pytest-xdist worker run it)."""
    from filelock import FileLock

    from pyimcom_tpu_torch.coadd import Block

    cfg, out = _cfg(small_survey, "_whole", stop=0)
    with FileLock(out + ".lock"):
        if not os.path.exists(out):
            Block(cfg=cfg, this_sub=1, device="cpu")
    return out


@pytest.fixture(scope="module")
def killed(small_survey):
    """The block with a snapshot after every group, killed after its 2nd
    snapshot; returns (output path, snapshot path, a copy of the snapshot)."""
    from pyimcom_tpu_torch.coadd import Block

    class Boom(Exception):
        pass

    orig, saves = Block._maybe_ckpt, []

    def dying(self):
        orig(self)
        saves.append(self._groups_drained)
        if len(saves) == 2:
            raise Boom("simulated kill")

    cfg, out = _cfg(small_survey, "_ckres", stop=0)
    ckpt = out[:-len(".fits")] + ".ckpt.npz"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Block, "_maybe_ckpt", dying)
        with pytest.raises(Boom):
            Block(cfg=cfg, this_sub=1, device="cpu", checkpoint_sec=0)
    assert saves == [1, 2] and not os.path.exists(out)
    copy = ckpt + ".copy.npz"
    shutil.copy(ckpt, copy)
    return out, ckpt, copy


def test_checkpoint_kill_and_resume(small_survey, killed, uninterrupted, capfd):
    from pyimcom_tpu_torch.coadd import Block

    out, ckpt, _copy = killed
    assert os.path.exists(ckpt), "the kill leaves the snapshot behind"
    cfg, _ = _cfg(small_survey, "_ckres", stop=0)
    blk = Block(cfg=cfg, this_sub=1, device="cpu", checkpoint_sec=0)
    said = capfd.readouterr().out
    assert "checkpoint: resuming after 2/4 groups" in said
    assert "checkpoint: skipping 2 completed groups" in said
    assert blk._ckpt_base == 2 and len(blk.stamp_stats) == 8
    assert blk.phase_times()["block.checkpoint"]["calls"] == 2
    assert not os.path.exists(ckpt), "the finished block removes the snapshot"
    _compare_outputs(uninterrupted, out, atol_sci=1e-11)


def test_snapshot_holds_the_reference_layout(small_survey, killed):
    """The reference's counters (int64 scalars) and every map the block
    keeps (float32): OUTMAPS "USTKN" less K, which one KAPPAC node drops."""
    from pyimcom_tpu.coadd import Block as RefBlock
    from pyimcom_tpu_torch.coadd import Block

    assert Block._CKPT_MAPS == RefBlock._CKPT_MAPS
    cfg, _ = _cfg(small_survey, "_never", stop=0)
    cfg()
    kept = {"out_map", "T_weightmap"} | {name for key, name in (
        ("U", "UC_map"), ("S", "Sigma_map"), ("K", "kappa_map"), ("T", "Tsum_map"),
        ("N", "Neff_map")) if key in cfg.outmaps}
    assert kept == set(RefBlock._CKPT_MAPS) - {"kappa_map"}
    with np.load(killed[2]) as z:
        assert set(z.files) == {"groups_done", "n_groups", "nrun"} | kept
        for k in ("groups_done", "n_groups", "nrun"):
            assert z[k].dtype == np.int64 and z[k].shape == ()
        assert (int(z["groups_done"]), int(z["n_groups"]), int(z["nrun"])) == (2, 4, 16)
        for k in kept:
            assert z[k].dtype == np.float32, k
        # the maps hold exactly the two drained groups: stamps of the first
        # stamp row are coadded, the third and fourth rows are still zero
        T = z["T_weightmap"]
        assert np.all(T[:, :, :2, :].sum(axis=1) != 0) and np.all(T[:, :, 2:, :] == 0)


def test_snapshot_of_another_geometry_is_ignored(small_survey, tmp_path, capsys):
    from pyimcom_tpu_torch.coadd import Block

    cfg, _ = _cfg(small_survey, "_never", stop=0)
    blk = Block(cfg=cfg, this_sub=1, run_coadd=False, device="cpu", checkpoint_sec=0)
    blk.outstem, blk.nrun = str(tmp_path / "blk"), 16
    snap = blk.outstem + ".ckpt.npz"
    maps = {"out_map": np.ones((1, 2, 3, 3), np.float32)}
    for n_groups, nrun in ((3, 16), (4, 12)):
        np.savez(snap, groups_done=np.int64(2), n_groups=np.int64(n_groups),
                 nrun=np.int64(nrun), **maps)
        blk._ckpt_load(4)
        assert blk._ckpt_base == 0 and blk._ckpt_maps is None
        assert f"checkpoint: {snap} is for a different geometry" in capsys.readouterr().out
    np.savez(snap, groups_done=np.int64(2), n_groups=np.int64(4), nrun=np.int64(16), **maps)
    blk._ckpt_load(4)
    assert blk._ckpt_base == 2 and list(blk._ckpt_maps) == ["out_map"]
    # without checkpoints the snapshot is not read
    off = Block(cfg=cfg, this_sub=1, run_coadd=False, device="cpu")
    off.outstem, off.nrun = blk.outstem, 16
    off._ckpt_load(4)
    assert off._ckpt_base == 0 and off._ckpt_maps is None
