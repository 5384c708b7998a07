"""The chained pipeline's stages after destripe, pyimcom_tpu_torch.pipeline,
against the same stages of the JAX package (scripts/run_chained_pipeline.py)
on the CPU.

pipeline.build makes the survey (build_survey(n_obs=6): 4 F184 exposures
at 4088^2, cstar14 and whitenoise1 layers, striped), cut for the CPU to
2 x 2 stamps of 16 px at 0.04" a block, NPIXPSF 12, INPAD 0.25, PAD 1 on
every side, and the first group of each block (STOP 4: the corner group of
pad stamps and one interior stamp).  The stages:

* layers (layer_wrapper.build_all_layers): the port builds two exposures
  and an absent one in this process (nworkers=1) and the other two over a
  forkserver pool of two workers; the JAX package builds one exposure of
  each path and the absent one.  The science layer is equal, the injected
  layers within 1e-12 of their peak (tests/test_torch_layer.py's bound),
  the statuses the same;
* the four blocks of each package (the reference's device engine,
  PYIMCOM_DEVICE_ASSEMBLY=1, on one device), both from the port's layer
  caches so that they coadd the same inputs, as coadded and after each
  package's halo exchange with every block saved: compare_outputs_f32
  (science 1e-8 of scale or one float32 ulp, maps 1 LSB, INWEIGHT 1e-8);
* compress_all_blocks of both packages on the same (the reference's)
  block files: the packed files read back equal bit for bit, raw and
  through ReadFile; the port's packed blocks read back within the I24B
  step plus float32 noise of its own blocks (pipeline.compression_check);
* bench's post-pass processes (postpass_child) on copies of the port's
  coadded blocks: the runner's --all --share-pads and compress_all_blocks
  write what the stages wrote, bit for bit, with no torch import;
* OutImage's accessors, NoiseAnal and the Mosaic's coverage, consumption,
  noise-spectrum and star-catalog products on the reference's block files:
  equal bit for bit.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from test_torch_block import compare_outputs_f32
from test_torch_hostio import _same
from test_torch_mosaic import assert_same_files, block_path, copy_blocks

torch.set_num_threads(1)

CPU_CUT = dict(n_obs=6, n1=2, npixpsf=12, inpad=0.25, stamp=(16, 0.04))
ABSENT = (0, 2)          # an (obs, sca) of the survey with no input file


def _cache(cfg, idsca):
    """The layer cube of one exposure in the cache of `cfg`."""
    from pyimcom_tpu_torch.fitsio import fits_read

    return np.asarray(fits_read(cfg["INLAYERCACHE"] + f"_{idsca[0]:08d}_{idsca[1]:02d}.fits")[0].data)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """Both packages' stages after destripe on one survey; returns the
    configurations, the stage results and the coadded blocks' copies."""
    from pyimcom_tpu import layer_wrapper as ref_lw
    from pyimcom_tpu.analysis import Mosaic as RefMosaic
    from pyimcom_tpu.coadd import Block as RefBlock
    from pyimcom_tpu.config import Config as RefConfig
    from pyimcom_tpu_torch import pipeline
    from pyimcom_tpu_torch.config import Config
    from pyimcom_tpu_torch.layer_wrapper import build_all_layers

    root = tmp_path_factory.mktemp("chain")
    cfg = dict(pipeline.build(root / "w", **CPU_CUT), STOP=4)
    port = dict(cfg, OUT=cfg["OUT"] + "_port", INLAYERCACHE=str(root / "cache_port" / "in"))
    ref = dict(port, OUT=cfg["OUT"] + "_ref")
    jax_cache = dict(ref, INLAYERCACHE=str(root / "cache_ref" / "in"))
    present = sorted((int(m.group(1)), int(m.group(2))) for m in (
        re.search(r"_(\d+)_(\d+)\.fits$", p) for p in pipeline.raw_images(root / "w")))
    assert len(present) == 4 and ABSENT not in present
    out = {"cfg": cfg, "ref": ref, "port": port, "jax_cache": jax_cache,
           "paths": {"in-process": (present[0], ABSENT), "pool": (present[2],)}}

    out["in-process"] = build_all_layers(Config(dict(port)), idscas=present[:2] + [ABSENT],
                                         nworkers=1, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")      # read by the workers' torch
        out["pool"] = build_all_layers(Config(dict(port)), idscas=present[2:], nworkers=2,
                                       device="cpu")
    out["ref_layers"] = ref_lw.build_all_layers(
        RefConfig(dict(jax_cache)), idscas=[present[0], ABSENT, present[2]], nworkers=1)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYIMCOM_DEVICE_ASSEMBLY", "1")
        mp.setenv("PYIMCOM_NDEVICES", "1")
        for sub in range(4):
            RefBlock(cfg=RefConfig(dict(ref)), this_sub=sub)
    out["ref_coadd"] = copy_blocks(ref["OUT"], str(root / "ref_coadd"))
    mos = RefMosaic(ref["OUT"], nblock=2)
    mos.share_padding_stamps()
    for oi in mos.images.values():
        oi.save()
    out["ref_packed"] = ref_lw.compress_all_blocks(RefConfig(dict(ref)))

    out["port_blocks"] = pipeline.coadd(port, device="cpu")
    out["port_coadd"] = copy_blocks(port["OUT"], str(root / "port_coadd"))
    out["exchanged"] = pipeline.halo_exchange(port)
    out["port_packed"] = pipeline.compress(port)
    return out


@pytest.mark.parametrize("path", ["in-process", "pool"])
def test_layer_caches_match_reference(chain, path):
    """build_all_layers of the port, in this process (nworkers=1) or over
    two forkserver workers, against the JAX one on the exposures both
    built: the statuses, and the cubes."""
    want = {tuple(i): s for i, s in chain["ref_layers"]}
    got = {tuple(i): (s, k) for i, s, k in chain[path]}
    assert len(got) == {"in-process": 3, "pool": 2}[path]
    assert all(k == 0 for _, k in got.values())          # no K1 launch on the CPU
    for idsca in chain["paths"][path]:
        assert got[idsca][0] == want[idsca] == ("missing" if idsca == ABSENT else "ok")
        if idsca == ABSENT:
            continue
        cube, ref = _cache(chain["port"], idsca), _cache(chain["jax_cache"], idsca)
        assert cube.shape == ref.shape == (3, 4088, 4088)
        np.testing.assert_array_equal(cube[0], ref[0])
        for il in (1, 2):
            peak = np.abs(ref[il]).max()
            assert peak > 0
            np.testing.assert_allclose(cube[il], ref[il], rtol=0, atol=1e-12 * peak)


@pytest.mark.parametrize("sub", range(4))
def test_coadd_stage_matches_reference(chain, sub):
    compare_outputs_f32(block_path(chain["ref_coadd"], sub), block_path(chain["port_coadd"], sub))


@pytest.mark.parametrize("sub", range(4))
def test_halo_exchange_stage_matches_reference(chain, sub):
    assert chain["exchanged"] == 4
    ref, port = (block_path(chain[k]["OUT"], sub) for k in ("ref", "port"))
    compare_outputs_f32(ref, port)
    from pyimcom_tpu_torch.fitsio import fits_read

    # the exchange filled the pads: the block differs from its coadded copy
    assert not np.array_equal(fits_read(port)[0].data,
                              fits_read(block_path(chain["port_coadd"], sub))[0].data)


def test_compress_stage_matches_reference(chain, tmp_path):
    """compress_all_blocks of the port on copies of the reference's
    exchanged blocks writes what the JAX one wrote, and the port's own
    packed blocks read back within pipeline.compression_check's bounds."""
    from pyimcom_tpu import compress as ref_compress
    from pyimcom_tpu_torch import compress, pipeline
    from pyimcom_tpu_torch.layer_wrapper import compress_all_blocks

    stem = copy_blocks(chain["ref"]["OUT"], str(tmp_path / "q"))
    got = compress_all_blocks(dict(chain["ref"], OUT=stem))
    assert [os.path.basename(p).replace("q_", "") for p in got] == \
        [os.path.basename(p).replace("testout_F_ref_", "") for p in chain["ref_packed"]]
    for mine, theirs in zip(got, chain["ref_packed"]):
        assert_same_files(mine, theirs)
        for h_got, h_want in zip(compress.ReadFile(mine), ref_compress.ReadFile(theirs)):
            assert h_got.name == h_want.name
            assert _same(h_got.data if isinstance(h_got.data, dict) else np.asarray(h_got.data),
                         h_want.data if isinstance(h_want.data, dict)
                         else np.asarray(h_want.data))
    assert len(chain["port_packed"]) == 4
    for packed in chain["port_packed"]:
        check = pipeline.compression_check(packed.replace(".cpr.fits.gz", ".fits"), packed)
        assert sorted(check["layers"]) == [1, 2] and all(check["equal"].values()), check
        for rec in check["layers"].values():
            assert rec["max_abs_err"] <= rec["bound"], check


def test_postpass_processes_match_stages(chain, tmp_path):
    """bench.postpass_child's exchange (the runner's --all --share-pads over
    finished blocks) and compression, each in a fresh process that never
    imports torch, on copies of the port's coadded blocks: the blocks and
    packed files equal the halo_exchange and compress stages' bit for bit,
    and each record holds its seconds and memory."""
    from pyimcom_tpu_torch.bench import postpass_child

    stem = copy_blocks(chain["port_coadd"], str(tmp_path / "p"))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(dict(chain["port"], OUT=stem)))
    recs = [postpass_child(cfg_path, what) for what in ("share_pads", "compress")]
    for sub in range(4):
        assert_same_files(block_path(stem, sub), block_path(chain["port"]["OUT"], sub))
        assert_same_files(block_path(stem, sub)[:-5] + ".cpr.fits.gz", chain["port_packed"][sub])
    for rec in recs:
        assert not rec["torch_imported"]
        assert rec["seconds"] > 0 and 0 < rec["rss_before_MiB"] <= rec["peak_rss_MiB"], rec


def test_analysis_of_reference_blocks_matches_jax(chain, tmp_path):
    """OutImage, NoiseAnal and the Mosaic's products of the port on the
    reference's exchanged blocks equal the JAX package's."""
    from pyimcom_tpu import analysis as ref
    from pyimcom_tpu_torch import analysis

    path = block_path(chain["ref"]["OUT"], 1)
    a, b = ref.OutImage(path), analysis.OutImage(path)
    assert (a.ibx, a.iby) == (b.ibx, b.iby) == (0, 1)
    assert a.hdu_names == b.hdu_names
    for layer in ("SCI", "cstar14", "whitenoise1", 2):
        assert _same(a.get_coadded_layer(layer), b.get_coadded_layer(layer))
    assert _same(a.get_T_weightmap(), b.get_T_weightmap())
    for padding in (False, True):
        assert a.get_mean_coverage(padding) == b.get_mean_coverage(padding)
    for name in analysis.OutImage.MAP_HDUS:
        if name in b.hdu_names:
            assert _same(a.get_output_map(name), b.get_output_map(name)), name
    assert _same(a.get_weight_map("whitenoise1"), b.get_weight_map("whitenoise1"))
    for kw in ({}, {"padding": True, "win": True}, {"bin_flag": 0}):
        na, nb = ref.NoiseAnal(a, "whitenoise1")(**kw), analysis.NoiseAnal(b, "whitenoise1")(**kw)
        for attr in ("ps2d", "ps1d", "wavenumbers"):
            assert _same(getattr(na, attr), getattr(nb, attr)), (kw, attr)
    assert _same(ref.NoiseAnal(a).power_spectrum(8), analysis.NoiseAnal(b).power_spectrum(8))

    mosaics = {}
    for name, mod in (("jax", ref), ("port", analysis)):
        mosaics[name] = mod.Mosaic(copy_blocks(chain["ref"]["OUT"], str(tmp_path / name)))
        mosaics[name]()
    ma, mb = mosaics["jax"], mosaics["port"]
    for attr in ("consump_map", "coverage_map", "ps2d_all", "ps1d_all", "wavenumbers",
                 "star_cat"):
        assert _same(getattr(ma, attr), getattr(mb, attr)), attr
    assert _same(ma.mean_coverage_map(), mb.mean_coverage_map())


def test_pipeline_without_gpu_raises(tmp_path):
    """The chain asks for the card by default and raises, before any stage,
    where there is none."""
    from pyimcom_tpu_torch import pipeline

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the chain runs in chip_smoke.py")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        pipeline.main(["--workdir", str(tmp_path / "w")])
    assert not (tmp_path / "w").exists()
