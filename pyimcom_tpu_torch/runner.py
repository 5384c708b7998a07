"""
Mosaic-scale runs of the block coadd.

Counterpart of pyimcom_tpu/runner.py: the blocks of a mosaic are
independent jobs, run in this process, over a local process pool, or round
robin over the ranks of a multi-process run, each rank on its own card.
The prime-stride block order (stride 691) matches the reference, so that a
partial run is an unbiased spatial sample of the mosaic.  A finished block
(its output file exists) is skipped, which makes a rerun idempotent; with
``checkpoint_sec`` an interrupted block resumes from its snapshot.

    python -m pyimcom_tpu_torch.runner cfg.json --block N | --all
        [--workers K] [--checkpoint-sec S] [--device cuda|cpu] [--share-pads]
        [--report]

``--all`` runs this rank's share of the blocks (host_blocks): every block
in a single-process run.  ``--share-pads`` then runs the padding-stamp halo
exchange over the mosaic's block files (analysis.Mosaic) and saves every
block.  ``--report`` then builds the validation report
(diagnostics.run.run_report) of the first block, ``_00_00`` or else the
first block file found, into ``<OUT>_report.pdf`` and ``<OUT>_data.txt``;
it needs matplotlib.
"""

from __future__ import annotations

import argparse
import os
import sys

from .config import Config

PRIME_STRIDE = 691


def block_order(nblock: int, nrun: int = None):
    """Prime-stride permutation of block indices (unbiased subsampling)."""
    total = nblock * nblock
    nrun = total if nrun is None else min(nrun, total)
    return [int(i * PRIME_STRIDE % total) for i in range(nrun)]


def run_block(cfg, this_sub: int, skip_existing: bool = True, device="cuda",
              **block_kw) -> str:
    """Coadd one block; returns the output path.  A block whose output
    exists is skipped (the reference's idempotent re-run).  `block_kw` goes
    to Block (checkpoint_sec, pool_budget_bytes)."""
    if isinstance(cfg, dict):
        cfg = Config(dict(cfg))
    cfg()
    ibx, iby = divmod(this_sub, cfg.nblock)
    outfile = cfg.outstem + f"_{ibx:02d}_{iby:02d}.fits"
    if skip_existing and os.path.exists(outfile):
        print(f"block {this_sub} already done -> {outfile}", flush=True)
        return outfile
    from .coadd import Block

    Block(cfg=cfg, this_sub=this_sub, device=device, **block_kw)
    return outfile


def run_mosaic(cfg, blocks=None, nworkers: int = 1, device="cuda", **block_kw):
    """
    Run all (or the listed) blocks of a mosaic; returns their output paths.
    Finished blocks are skipped (run_block).

    nworkers > 1 fans the blocks over a forkserver process pool (a fork
    after CUDA is initialized is unsafe); the workers share the card, so
    each block is given an equal part of the default pool budget
    (coadd.default_pool_budget) unless `block_kw` sets pool_budget_bytes.
    """
    cfg_dict = cfg.to_dict() if isinstance(cfg, Config) else dict(cfg)
    if blocks is None:
        blocks = block_order(Config(dict(cfg_dict)).nblock)

    if nworkers <= 1:
        return [run_block(Config(dict(cfg_dict)), b, device=device, **block_kw)
                for b in blocks]

    import concurrent.futures
    import multiprocessing

    from .coadd import default_pool_budget

    block_kw.setdefault("pool_budget_bytes",
                        default_pool_budget(device, min(nworkers, len(blocks))))
    ctx = multiprocessing.get_context("forkserver")
    outs, failures = [], []
    with concurrent.futures.ProcessPoolExecutor(max_workers=nworkers,
                                                mp_context=ctx) as pool:
        futs = {pool.submit(run_block, cfg_dict, b, device=device, **block_kw): b
                for b in blocks}
        for fut in concurrent.futures.as_completed(futs):
            try:
                outs.append(fut.result())
            except Exception as e:  # noqa: BLE001 - gathered and raised below
                failures.append((futs[fut], repr(e)))
    if failures:
        raise RuntimeError(f"{len(failures)} blocks failed: {failures[:3]}")
    return outs


def host_blocks(nblock: int, process_index: int = None, process_count: int = None):
    """
    The round-robin block share of one rank of a multi-process run (the
    counterpart of the reference's Slurm job-array assignment).  The rank
    and world size default to torch.distributed's when it is initialized,
    else to the RANK and WORLD_SIZE environment variables (0 and 1 when
    unset).
    """
    if process_index is None:
        # a process that never imported torch has no process group (and the
        # post-passes over finished blocks never import it)
        dist = sys.modules.get("torch.distributed")
        if dist is not None and dist.is_available() and dist.is_initialized():
            process_index, process_count = dist.get_rank(), dist.get_world_size()
        else:
            process_index = int(os.environ.get("RANK", "0"))
            process_count = int(os.environ.get("WORLD_SIZE", "1"))
    order = block_order(nblock)
    return order[process_index::max(process_count, 1)]


def share_pads(outstem) -> int:
    """The padding-stamp halo exchange post-pass over the block files
    ``outstem_XX_YY.fits`` (analysis.Mosaic.share_padding_stamps), every
    block saved back to its file; returns the number of blocks."""
    from .analysis import Mosaic

    mos = Mosaic(outstem)
    mos.share_padding_stamps()
    for oi in mos.images.values():
        oi.save()
    return len(mos.images)


def first_block(outstem):
    """The mosaic's block ``outstem_00_00.fits``, or else the first block
    file ``outstem_XX_YY.fits`` in name order; None without one."""
    import glob

    first = outstem + "_00_00.fits"
    if os.path.exists(first):
        return first
    found = sorted(glob.glob(outstem + "_[0-9][0-9]_[0-9][0-9].fits"))
    return found[0] if found else None


def main(argv=None):
    ap = argparse.ArgumentParser(description="pyimcom_tpu_torch mosaic runner")
    ap.add_argument("config", help="JSON configuration file")
    ap.add_argument("--block", type=int, default=None, help="run one block index")
    ap.add_argument("--all", action="store_true",
                    help="run all blocks (this rank's share in a multi-process run)")
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--checkpoint-sec", type=float, default=None,
                    help="snapshot each block every S seconds (0: every group) and "
                         "resume an interrupted block from its snapshot")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--report", action="store_true", help="build the report after")
    ap.add_argument("--share-pads", action="store_true",
                    help="run the padding-stamp halo exchange post-pass")
    args = ap.parse_args(argv)

    cfg = Config(args.config)
    kw = dict(device=args.device, checkpoint_sec=args.checkpoint_sec)
    if args.block is not None:
        run_block(cfg, args.block, **kw)
    elif args.all:
        run_mosaic(cfg, blocks=host_blocks(cfg.nblock), nworkers=args.workers, **kw)
    else:
        print("specify --block N or --all")
        return 1

    if args.share_pads:
        n = share_pads(cfg.outstem)
        print(f"halo exchange applied to {n} blocks", flush=True)

    if args.report:
        first = first_block(cfg.outstem)
        if first:
            from .diagnostics.run import run_report

            run_report(first, cfg.outstem)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
