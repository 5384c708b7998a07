"""
The port's benchmark line: blocks/hour of the bench block on the card.

Counterpart of the repository's ``bench.py``.  It coadds the bench block
(BASELINE.json configs[0]: the synthetic survey of
``tests/survey_fixture_torch.build_survey(n_obs=8, extrainput=["cstar14"])``,
block 1, Cholesky) with :class:`pyimcom_tpu_torch.coadd.Block` -- a cold run
that builds the input layers, then the measured warm run -- and prints one
JSON line::

    {"metric": "blocks/hour", "value": ..., "unit": ..., "vs_baseline": ...}

The unit carries the stamps coadded, the star recovery SL1, the U/C median
(decoded as ``bench.quality_check`` decodes it) and the card's name and power
limit.  ``vs_baseline`` is the ratio to the CPU reference block recorded in
``.bench_cpu_baseline.json`` when that record is of the same fixture
(``fixture_key``), else null.  ``--production`` coadds a region of a
production-geometry block (OUTSIZE [80, 32, 0.0390625], INPAD 1.055, NPIXPSF
48) instead and prints ``production_stamp_seconds`` with the peak device
memory and the retained submatrix pools.  ``--postpass`` times the mosaic
post-passes at production block size instead (:func:`postpass`) and prints
``postpass_seconds``.

    python -m pyimcom_tpu_torch.bench [--full] [--production | --postpass]
                                      [--stop N] [--device cuda|cpu]
                                      [--checkpoint-sec S] [--psfinterp G4460]

``--stop N`` coadds N stamps (bench default: all 16 on the card, 4 on the
CPU; ``--full`` is all 16; production default 8, 0 the whole 2560^2 block;
post-passes default 4 a block).  ``--psfinterp G4460`` coadds the bench
block with the 8-tap interpolation family (K1 and K2 in their G4460
forms); the CPU baseline is of the D5512 block, so that line has none.
The surveys are written under ``.bench_work/`` in the repository
(git-ignored) and reused.  A SIGTERM before the result prints a line with
a null value, marked partial, and exits.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
WORK = REPO / ".bench_work"
BASELINE = REPO / ".bench_cpu_baseline.json"
BENCH_STAMPS = 16                 # stamps of the bench block
PRODUCTION = {"OUTSIZE": [80, 32, 0.0390625], "INPAD": 1.055, "NPIXPSF": 48}
STAR = (60.0508, -3.8005)         # the survey's science star (ra, dec)
# the post-passes' mosaic: 2x2 production blocks padded on every side
POSTPASS = dict(PRODUCTION, PAD=1, PADSIDES="all", BLOCK=2,
                EXTRAINPUT=["cstar14", "whitenoise1"])

# One post-pass in a fresh process: the runner's ``--all --share-pads`` over
# finished blocks (it skips them, so torch is never imported) or
# compress_all_blocks.  Prints its seconds, its resident memory after the
# imports and the peak of it during the pass, VmRSS sampled every 5 ms by a
# thread: ru_maxrss carries the parent's peak across the exec, and VmHWM is
# not offered by every kernel's /proc.
POSTPASS_CHILD = r"""
import json, sys, threading, time
from pathlib import Path
from pyimcom_tpu_torch import runner
from pyimcom_tpu_torch.config import Config
from pyimcom_tpu_torch.layer_wrapper import compress_all_blocks

def rss_mib():
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) / 1024
    raise RuntimeError("/proc/self/status has no VmRSS")

cfg_path, what = sys.argv[1], sys.argv[2]
before = rss_mib()
peak, done = [before], threading.Event()

def sample():
    while not done.wait(0.005):
        peak[0] = max(peak[0], rss_mib())

sampler = threading.Thread(target=sample, daemon=True)
sampler.start()
t0 = time.perf_counter()
if what == "share_pads":
    runner.main([cfg_path, "--all", "--share-pads"])
else:
    compress_all_blocks(Config(cfg_path))
seconds = time.perf_counter() - t0
done.set()
sampler.join()
print(json.dumps({"seconds": seconds, "rss_before_MiB": before,
                  "peak_rss_MiB": max(peak[0], rss_mib()),
                  "torch_imported": "torch" in sys.modules}))
"""

# what the SIGTERM handler prints
PARTIAL = {"metric": "blocks/hour", "value": None,
           "unit": "benchmark interrupted before any measurement",
           "vs_baseline": None, "partial": True}


def _flush_partial(sig, frame):
    print(json.dumps(PARTIAL), flush=True)
    os._exit(0)


def fixture_key(cfg_dict) -> str:
    """The key of a bench fixture's geometry (bench._fixture_key)."""
    keys = ("OUTSIZE", "BLOCK", "INPAD", "EXTRAINPUT", "LAKERNEL", "UCMIN")
    s = json.dumps({k: cfg_dict.get(k) for k in keys}, sort_keys=True)
    return hashlib.sha256(s.encode()).hexdigest()[:16]


def cpu_baseline(cfg_dict):
    """The CPU reference record of .bench_cpu_baseline.json when it is of
    this fixture (a D5512 block), else None."""
    if not BASELINE.exists() or cfg_dict.get("PSFINTERP", "D5512") != "D5512":
        return None
    rec = json.loads(BASELINE.read_text())
    return rec if rec.get("fixture_key") == fixture_key(cfg_dict) else None


def card_label(device) -> str:
    """'name, power limit' of the card (nvidia-smi), or 'cpu'."""
    import torch

    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def survey(workdir, overrides=None):
    """The bench survey in `workdir`, built once (its cfg.json marks it)."""
    workdir = Path(workdir)
    if (workdir / "cfg.json").exists():
        return dict(json.loads((workdir / "cfg.json").read_text()), **(overrides or {}))
    sys.path.insert(0, str(REPO / "tests"))
    from survey_fixture_torch import build_survey

    return build_survey(workdir, n_obs=8, extrainput=["cstar14"],
                        config_overrides=overrides)


def run_region(cfg_dict, this_sub=1, stop=4, out_suffix="", device="cuda",
               checkpoint_sec=None):
    """Coadd `stop` stamps (0: the whole block) of block `this_sub`;
    returns (seconds, the Block).  An earlier output of the same name is
    removed first."""
    import torch

    from .coadd import Block
    from .config import Config

    d = dict(cfg_dict)
    if stop:
        d["STOP"] = stop
    d["OUT"] = d["OUT"] + out_suffix
    ibx, iby = divmod(this_sub, d["BLOCK"])
    out = d["OUT"] + f"_{ibx:02d}_{iby:02d}.fits"
    if os.path.exists(out):
        os.remove(out)
    cfg = Config(d)
    t0 = time.time()
    blk = Block(cfg=cfg, this_sub=this_sub, device=device, checkpoint_sec=checkpoint_sec)
    if blk.device.type == "cuda":
        torch.cuda.synchronize(blk.device)
    return time.time() - t0, blk


def quality_check(path):
    """Star recovery SL1 and the U/C median of a bench output block
    (bench.quality_check): SL1 fits the target PSF at the science star to
    layer 0 in the stamp [0:25, 25:50]; the U/C median is over the FIDELITY
    map's decoded values with 1e-10 < U/C < 0.5 (never-coadded pixels
    saturate the encoding)."""
    from .fitsio import fits_read
    from .wcsutil import WCS

    f = fits_read(path)
    w = WCS.from_header(f[0].header)
    xs, ys = w.world2pix(*STAR)
    d = np.asarray(f[0].data[0, 0], dtype=np.float64)
    sig = 0.9265328730414752 * 0.11 / 0.04
    sc = (0.04 / 0.11) ** 2
    yy, xx = np.mgrid[0:d.shape[0], 0:d.shape[1]]
    p = np.exp(-0.5 * ((xx - float(xs)) ** 2 + (yy - float(ys)) ** 2) / sig ** 2) \
        / (2 * np.pi * sig ** 2 * sc)
    region = np.s_[0:25, 25:50]
    SL1 = float(np.sum((p * d)[region]) / np.sum((p ** 2)[region]))
    return SL1, uc_median(f)


def uc_median(block):
    """The U/C median of an output block (a path or its HDUList) as
    bench.quality_check decodes it: the FIDELITY map's values with 1e-10 <
    U/C < 0.5 (never-coadded pixels saturate the encoding); 1.0 if none."""
    from .fitsio import fits_read

    f = fits_read(block) if isinstance(block, (str, Path)) else block
    uc = 10.0 ** (np.asarray(f["FIDELITY"].data, dtype=np.float64) / -5000.0)
    good = (uc > 1e-10) & (uc < 0.5)
    return float(np.median(uc[good])) if np.any(good) else 1.0


def line(seconds, nrun, SL1, uc_med, card, baseline):
    """The bench line of a block of `nrun` stamps coadded in `seconds`."""
    bph = 3600.0 / (seconds * BENCH_STAMPS / nrun)
    base = ("no cpu baseline of this fixture" if baseline is None else
            f"cpu baseline {3600.0 / baseline['t_block_cpu']:.2f} b/h, "
            f"{baseline['cpu_note']}")
    return {"metric": "blocks/hour", "value": bph,
            "unit": f"synthetic 100px blocks/hour on {card} ({nrun}/{BENCH_STAMPS} stamps, "
                    f"SL1={SL1:.5f}, U/C med={uc_med:.1e} (SL1 {SL1!r}, U/C med "
                    f"{uc_med!r}); {base})",
            "vs_baseline": None if baseline is None else bph * baseline["t_block_cpu"] / 3600.0}


def bench_block(cfg_dict, device="cuda", stop=0, warmup=True):
    """The bench block (a cold run first when `warmup`, then the measured
    run); returns (the line, the measured Block, SL1, U/C median)."""
    if warmup:
        run_region(cfg_dict, stop=stop, out_suffix="_warmup", device=device)
    dt, blk = run_region(cfg_dict, stop=stop, out_suffix="_bench", device=device)
    SL1, uc_med = quality_check(blk.outstem + ".fits")
    return (line(dt, blk.nrun, SL1, uc_med, card_label(device), cpu_baseline(cfg_dict)),
            blk, SL1, uc_med)


def production(stop=8, device="cuda", workdir=None, checkpoint_sec=None):
    """`stop` stamps (0: all 6400) of a production-geometry block; returns
    the production_stamp_seconds line.  Its seconds and stamps are this
    run's: a block resumed from a snapshot counts only the stamps after it."""
    import torch

    cfg_dict = survey(workdir or WORK / "production", dict(PRODUCTION, STOP=stop))
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    dt, blk = run_region(cfg_dict, stop=stop, out_suffix="_prod", device=device,
                         checkpoint_sec=checkpoint_sec)
    stamps = len(blk.stamp_stats)
    ps = blk.pool_stats
    mem = ""
    if dev.type == "cuda":
        mem = (f"; peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
               f"allocated, {torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB reserved")
    budget = ps["budget_bytes"]
    return {"metric": "production_stamp_seconds", "value": dt / max(stamps, 1),
            "unit": f"s per 32x32-px production stamp ({stamps} stamps of a 2560^2 block "
                    f"on {card_label(device)}, after {blk._ckpt_base} groups restored from a "
                    f"snapshot{mem}; retained pools peak {ps['peak_bytes'] / 2**30:.2f} GiB, "
                    f"budget {budget / 2**30:.2f} GiB, {ps['evictions']} evictions)",
            "vs_baseline": None,
            # the run's own numbers, for the record (bench.py's line has no such keys)
            "block_s": dt, "stamps": stamps, "restored_groups": blk._ckpt_base,
            "retained_peak_bytes": ps["peak_bytes"], "evictions": ps["evictions"],
            "phases": {k: {"host_s": v["host_s"], "device_ms": v["device_ms"],
                           "calls": v["calls"]} for k, v in blk.phase_times().items()}}


def postpass_child(cfg_path, what):
    """Run one post-pass ("share_pads" or "compress") over the finished
    blocks of `cfg_path` in a fresh process; returns its record."""
    proc = subprocess.run([sys.executable, "-c", POSTPASS_CHILD, str(cfg_path), what],
                          cwd=REPO, capture_output=True, text=True, timeout=3000)
    if proc.returncode:
        raise RuntimeError(f"the {what} post-pass failed:\n{proc.stderr[-3000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    if rec["torch_imported"]:
        raise RuntimeError(f"the {what} post-pass imported torch; its memory is not its own")
    return rec


def postpass(stop=4, device="cuda"):
    """The mosaic post-passes at production block size: a 2x2 mosaic of
    2624^2 blocks (production geometry, PAD 1 on every side, cstar14 and
    whitenoise1 on the bench survey, in .bench_work/postpass/, rebuilt every
    run), `stop` stamps of every block coadded by ``python -m
    pyimcom_tpu_torch.runner cfg.json --all``, then the halo exchange
    (``runner cfg.json --all --share-pads``) and compression
    (layer_wrapper.compress_all_blocks), each in a fresh process
    (postpass_child); returns the postpass_seconds line."""
    work = WORK / "postpass"
    shutil.rmtree(work, ignore_errors=True)
    cfg_dict = survey(work, dict(POSTPASS, STOP=stop))
    cfg_path = work / "cfg.json"
    subprocess.run([sys.executable, "-m", "pyimcom_tpu_torch.runner", str(cfg_path), "--all",
                    "--device", device], cwd=REPO, check=True, timeout=3000,
                   stdout=subprocess.DEVNULL)
    out = Path(cfg_dict["OUT"])
    blocks = sorted(out.parent.glob(out.name + "_[0-9][0-9]_[0-9][0-9].fits"))
    share = postpass_child(cfg_path, "share_pads")
    packed = postpass_child(cfg_path, "compress")
    return {"metric": "postpass_seconds", "value": share["seconds"] + packed["seconds"],
            "unit": (f"s of the halo exchange and compression of {len(blocks)} blocks of "
                     f"{stop} coadded stamps, in host processes beside {card_label(device)}"),
            "vs_baseline": None,
            "block_MB": [os.path.getsize(p) / 1e6 for p in blocks],
            "share_pads": share, "compress": packed,
            "packed_MB": [os.path.getsize(p) / 1e6 for p in
                          sorted(out.parent.glob(out.name + "_*.cpr.fits.gz"))]}


def main(argv=None):
    ap = argparse.ArgumentParser(description="pyimcom_tpu_torch benchmark line")
    ap.add_argument("--full", action="store_true", help="coadd all 16 bench stamps")
    ap.add_argument("--production", action="store_true",
                    help="seconds a stamp of a production-geometry block")
    ap.add_argument("--postpass", action="store_true",
                    help="seconds and peak memory of the mosaic post-passes at "
                         "production block size")
    ap.add_argument("--stop", type=int, default=None,
                    help="stamps to coadd (bench: 0 = all 16; production: 0 = the block; "
                         "post-passes: a block)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--checkpoint-sec", type=float, default=None,
                    help="production: snapshot the block every S seconds and resume from it")
    ap.add_argument("--psfinterp", default="D5512", choices=("D5512", "G4460"),
                    help="bench block: the interpolation family (PSFINTERP)")
    args = ap.parse_args(argv)
    signal.signal(signal.SIGTERM, _flush_partial)

    if args.production:
        stop = 8 if args.stop is None else args.stop
        print(json.dumps(production(stop, args.device, checkpoint_sec=args.checkpoint_sec)),
              flush=True)
        return 0
    if args.postpass:
        print(json.dumps(postpass(4 if args.stop is None else args.stop, args.device)),
              flush=True)
        return 0
    if args.full:
        stop = 0
    elif args.stop is not None:
        stop = args.stop
    else:
        stop = 0 if args.device.startswith("cuda") else 4
    cfg_dict = survey(WORK / "bench")
    if args.psfinterp != "D5512":
        cfg_dict = dict(cfg_dict, PSFINTERP=args.psfinterp)
    result, _blk, _SL1, _uc = bench_block(cfg_dict, args.device, stop)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
