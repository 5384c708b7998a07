"""
Parallel pre-generation of input layer caches, and compression of a run's
block files.

Counterpart of pyimcom_tpu/layer_wrapper.py.  Building the (n_inframe,
4088, 4088) layer cube of each exposure is independent of the others, so
:func:`build_all_layers` fans the exposures over a forkserver process pool
(a fork after CUDA is initialized is unsafe); the file-locked INLAYERCACHE
makes concurrent workers idempotent.  Each cube is built by the port's
:func:`pyimcom_tpu_torch.layer.get_all_data` under a
``Block(run_coadd=False, device=...)``, so star injection runs kernel K1 on
the card.  :func:`compress_all_blocks` compresses every block file of a run
with the port's copy of the compression package.
"""

from __future__ import annotations

import concurrent.futures
import multiprocessing
import os

from .config import Config

# the I24B parameters of compress_all_blocks (the reference's defaults)
I24B_PARS = {"VMIN": "-100.0", "VMAX": "100.0", "DIFF": "True", "SOFTBIAS": "-1"}


def build_one_layer(cfg_dict: dict, idsca, device="cuda") -> tuple:
    """Build (or load from the cache) the layer cube of one (obsid, sca);
    returns (idsca, "ok" or "missing", the K1 launches of this build).  The
    launches are counted in the process that builds the cube, which is a
    pool worker's under :func:`build_all_layers`."""
    from .coadd import Block, InImage
    from .layer import get_all_data
    from .ops import interp_cuda

    # a block context supplies the observation table and the WCS machinery
    blk = Block(cfg=Config(dict(cfg_dict)), this_sub=0, run_coadd=False, device=device)
    blk.parse_config()
    blk.pmask = None
    blk.use_instamps = None
    im = InImage(blk, tuple(idsca))
    if not im.exists_:
        return (idsca, "missing", 0)
    before = interp_cuda.launches["interp_d5512_dense"]
    get_all_data(im)
    return (idsca, "ok", interp_cuda.launches["interp_d5512_dense"] - before)


def build_all_layers(cfg, idscas=None, nworkers: int = None, device="cuda") -> list:
    """
    Build the layer caches of all (or the given) exposures; returns the
    :func:`build_one_layer` results.

    The worker count follows SLURM_CPUS_PER_TASK / OMP_NUM_THREADS when set
    (2 otherwise); one worker, or a one-core host, builds in this process.
    A failed build raises: in this process at once, from the pool after
    every build has ended (RuntimeError naming the failures).
    """
    cfg_dict = cfg.to_dict() if isinstance(cfg, Config) else dict(cfg)

    if idscas is None:
        from .coadd import Block

        blk = Block(cfg=Config(dict(cfg_dict)), this_sub=0, run_coadd=False, device=device)
        blk.parse_config()
        blk._get_obs_cover(1.0)
        idscas = blk.obslist

    if nworkers is None:
        nworkers = int(os.environ.get("SLURM_CPUS_PER_TASK",
                                      os.environ.get("OMP_NUM_THREADS", "2")))

    if nworkers <= 1 or (os.cpu_count() or 1) == 1:
        return [build_one_layer(cfg_dict, idsca, device) for idsca in idscas]

    results, failures = [], []
    ctx = multiprocessing.get_context("forkserver")
    with concurrent.futures.ProcessPoolExecutor(max_workers=nworkers,
                                                mp_context=ctx) as pool:
        futs = {pool.submit(build_one_layer, cfg_dict, idsca, device): idsca
                for idsca in idscas}
        for fut in concurrent.futures.as_completed(futs):
            try:
                results.append(fut.result())
            except Exception as e:  # noqa: BLE001 - gathered and raised below
                failures.append((futs[fut], repr(e)))
    if failures:
        raise RuntimeError(f"{len(failures)} layer builds failed: {failures[:3]}")
    return results


def compress_all_blocks(cfg) -> list:
    """
    Compress layers 1 and up of every existing block file of a run into
    ``<block>.cpr.fits.gz`` with I24B (:data:`I24B_PARS`); returns the
    written paths (the counterpart of the reference's
    compress/compressutils_wrapper.py).
    """
    from .compress import CompressedOutput

    if isinstance(cfg, dict):
        cfg = Config(dict(cfg))
    done = []
    for ibx in range(cfg.nblock):
        for iby in range(cfg.nblock):
            fname = cfg.outstem + f"_{ibx:02d}_{iby:02d}.fits"
            if not os.path.exists(fname):
                continue
            co = CompressedOutput(fname)
            for il in range(1, co.hdul[0].data.shape[-3]):
                co.compress_layer(il, "I24B", I24B_PARS)
            out = fname[:-5] + ".cpr.fits.gz"
            co.to_file(out)
            done.append(out)
    return done
