"""The port's mosaic runner, pyimcom_tpu_torch.runner, against
pyimcom_tpu.runner: the prime-stride block order and the round-robin share
of a rank equal the reference's; the rank comes from RANK / WORLD_SIZE when
torch.distributed is not initialized; the CLI coadds a block into the same
images Block writes, and a rerun skips the finished block; run_mosaic's
worker pool writes the images run_block writes; --share-pads runs the JAX
runner's halo-exchange post-pass; --report, which needs the unported
diagnostics, raises."""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_block import _cfg, small_survey  # noqa: F401
from test_torch_mosaic import port_mosaic  # noqa: F401
from pyimcom_tpu_torch import runner

torch.set_num_threads(1)


@pytest.mark.parametrize("nblock", [1, 2, 3, 7, 48])
@pytest.mark.parametrize("nrun", [None, 5])
def test_block_order_matches_reference(nblock, nrun):
    from pyimcom_tpu import runner as ref

    assert runner.block_order(nblock, nrun) == ref.block_order(nblock, nrun)


def test_host_blocks_from_environment(monkeypatch):
    from pyimcom_tpu import runner as ref

    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert runner.host_blocks(5) == runner.block_order(5)
    for rank in range(3):
        monkeypatch.setenv("RANK", str(rank))
        monkeypatch.setenv("WORLD_SIZE", "3")
        assert runner.host_blocks(5) == ref.host_blocks(5, rank, 3)
    assert sorted(sum((ref.host_blocks(5, r, 3) for r in range(3)), [])) == list(range(25))


@pytest.mark.parametrize("flag", ["--share-pads", "--report"])
def test_unported_flags_raise(flag, request, tmp_path):
    """--report raises.  --share-pads is ported: the port's runner with
    --all --share-pads on copies of the seam mosaic's four padded block
    files (tests/test_torch_mosaic.py; every block is done, so both runners
    skip the coadd) writes the files the JAX runner's post-pass writes, bit
    for bit."""
    if flag == "--report":
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            runner.main(["cfg.json", "--block", "1", flag])
        return
    from test_torch_mosaic import assert_same_files, block_path, copy_blocks

    from pyimcom_tpu import runner as ref

    mosaic = request.getfixturevalue("port_mosaic")
    stems = {}
    for name, main, extra in (("jax", ref.main, []), ("port", runner.main, ["--device", "cpu"])):
        stems[name] = copy_blocks(mosaic["port"], str(tmp_path / name))
        path = tmp_path / f"cfg_{name}.json"
        path.write_text(json.dumps(dict(mosaic["cfg"], OUT=stems[name])))
        assert main([str(path), "--all", flag, *extra]) == 0
    for sub in range(4):
        assert_same_files(block_path(stems["jax"], sub), block_path(stems["port"], sub))


def _same_images(path_a, path_b):
    """Two output files hold the same HDUs and data (not the CONFIG text,
    which names the output path)."""
    from pyimcom_tpu_torch.fitsio import fits_read

    a, b = fits_read(path_a), fits_read(path_b)
    assert [h.header.get("EXTNAME") for h in a] == [h.header.get("EXTNAME") for h in b]
    for ha, hb in zip(a, b):
        if ha.header.get("EXTNAME") == "CONFIG":
            continue            # the configuration text names the output path
        if isinstance(ha.data, dict):
            assert list(ha.data) == list(hb.data)
            for col in ha.data:
                np.testing.assert_array_equal(np.asarray(hb.data[col]),
                                              np.asarray(ha.data[col]))
        else:
            np.testing.assert_array_equal(np.asarray(hb.data), np.asarray(ha.data))


@pytest.fixture(scope="module")
def block_1(small_survey):
    """Block 1 of the reduced survey at STOP 1, coadded once by Block in
    this process for the CLI and the worker-pool tests; its output path."""
    from pyimcom_tpu_torch import coadd

    cfg, out_blk = _cfg(small_survey, "_rblock", stop=1)
    coadd.Block(cfg=cfg, this_sub=1, device="cpu")
    return out_blk


def test_cli_block_matches_block_and_skips_when_done(small_survey, block_1, tmp_path,
                                                     monkeypatch):
    from pyimcom_tpu_torch import coadd

    out_blk = block_1
    d = dict(small_survey, STOP=1, OUT=small_survey["OUT"] + "_rcli")
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(d))
    assert runner.main([str(path), "--block", "1", "--device", "cpu"]) == 0
    out_cli = d["OUT"] + "_00_01.fits"
    _same_images(out_blk, out_cli)

    def never(*a, **k):
        raise AssertionError("a finished block must not run again")

    monkeypatch.setattr(coadd, "Block", never)
    assert runner.run_block(dict(d), 1, device="cpu") == out_cli
    with pytest.raises(AssertionError, match="must not run"):
        runner.run_block(dict(d), 1, skip_existing=False, device="cpu")


def test_run_mosaic_worker_pool_matches_run_block(small_survey, block_1, monkeypatch):
    """Two blocks (one stamp each) over a pool of two forkserver workers
    write the files that Block (block 1, the module's run) and run_block
    (block 0) write in this process, and a rerun of the mosaic skips both."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # read by the workers' torch
    here = dict(small_survey, STOP=1, OUT=small_survey["OUT"] + "_rhere")
    pool = dict(here, OUT=small_survey["OUT"] + "_rpool")
    want = {block_1: pool["OUT"] + "_00_01.fits"}
    path = runner.run_block(dict(here), 0, device="cpu")
    want[path] = path.replace("_rhere", "_rpool")
    got = runner.run_mosaic(pool, blocks=[1, 0], nworkers=2, device="cpu")
    assert sorted(got) == sorted(want.values())
    for path, pooled in want.items():
        _same_images(path, pooled)
    stamp = {p: os.path.getmtime(p) for p in got}
    assert sorted(runner.run_mosaic(pool, blocks=[1, 0], nworkers=2, device="cpu")) == sorted(got)
    assert {p: os.path.getmtime(p) for p in got} == stamp
