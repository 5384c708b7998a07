"""
The chained production pipeline on the card: a 2x2-block mosaic at
production stamp geometry from striped exposures to compressed blocks.

Counterpart of scripts/run_chained_pipeline.py.  It builds the synthetic
survey of ``tests/survey_fixture_torch.build_survey`` (as
:mod:`pyimcom_tpu_torch.bench` does) with 32x32-px output stamps at
0.0390625"/px, INPAD 1.055", NPIXPSF 48 and PAD 1 on every side, so that
the padding-stamp halo exchange has real work, injects row stripes
(default_rng(99), scale 0.01) into the exposures, and runs the stages

    build -> destripe -> layers -> coadd (every block) -> halo_exchange
    -> compress -> report

each a plain function of this module.  It prints one JSON line: the
seconds of every stage, the science star's SL1 and VAR on block _00_01,
the U/C median of every block (decoded as :func:`bench.quality_check`
decodes it), the launches of kernels K1-K4 in every stage, the destriping
and compression checks, the report's PDF and datablock names, and the
card's name and power limit.

    python -m pyimcom_tpu_torch.pipeline [--workdir DIR] [--n-obs 8]
        [--maxiter 5] [--n1 8] [--npixpsf 48] [--inpad 1.055]
        [--artifact FILE] [--device cuda|cpu] [--no-report]

The run is written under ``--workdir`` (default ``.pipe_work_torch/`` in
the repository, git-ignored); a directory of an earlier run (it holds
``cfg_pipe.json``) is removed first.  The line goes to ``--artifact`` too
when given.  The destripe stage has no host route: a failure there ends the
run.  The report (diagnostics.run.run_report on block _00_01, with the row
stability of the destriped exposures) needs matplotlib, which ``run``
imports before its first stage; ``--no-report`` (``report=False``) leaves
the stage out.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
WORK = REPO / ".pipe_work_torch"
MARKER = "cfg_pipe.json"
STRIPE_SEED, STRIPE_SCALE = 99, 0.01
STAMP_PX, STAMP_SCALE = 32, 0.0390625          # production output stamps
_L2 = re.compile(r"(\w\d+)_(\d+)_(\d+)")
DS_PATTERN = r"ds_\w+?_(\d+)_(\d+)\.fits$"      # the destriped files' names


def _fixture():
    """tests/survey_fixture_torch, the jax-free survey builder."""
    tests = str(REPO / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import survey_fixture_torch

    return survey_fixture_torch


def _launches():
    """The launch counts of K1 / K2 (interp_cuda) and K3 / K4 (bilinear_cuda)."""
    from .ops import bilinear_cuda, interp_cuda

    return {**interp_cuda.launches, **bilinear_cuda.launches}


def inject_stripes(root, raw):
    """Copy each L2 image to root/clean, then add row stripes to it in place
    (default_rng(99), scale 0.01, written back as float32), as
    scripts/run_chained_pipeline.py does."""
    from .fitsio import HDUList, Header, ImageHDU, fits_read, fits_write

    (Path(root) / "clean").mkdir()
    rng = np.random.default_rng(STRIPE_SEED)
    for p in raw:
        shutil.copy(p, Path(root) / "clean" / Path(p).name)
        f = fits_read(p)
        img = np.asarray(f[0].data, np.float64)
        stripes = rng.normal(scale=STRIPE_SCALE, size=img.shape[0])
        fits_write(p, HDUList([ImageHDU((img + stripes[:, None]).astype(np.float32),
                                        header=Header(f[0].header))]))


def raw_images(root):
    """The survey's L2 science images (not the masks), sorted."""
    return sorted(str(p) for p in (Path(root) / "in").glob("sim_L2_*.fits")
                  if "_mask" not in p.name)


def build(work, n_obs=8, n1=8, npixpsf=48, inpad=1.055, stamp=(STAMP_PX, STAMP_SCALE)):
    """Stage 0: the survey in `work` (a fresh directory) with n1 x n1 stamps
    of `stamp` (pixels, arcsec a pixel; production stamps by default), PAD
    1 on every side, cstar14 and whitenoise1 layers, every block at STOP 0,
    striped exposures (clean copies in work/clean) and the destriping
    entries; returns the configuration dict, also written to cfg_pipe.json."""
    work = Path(work)
    cfg = _fixture().build_survey(work, n_obs=n_obs, extrainput=["cstar14", "whitenoise1"],
                                  config_overrides={"OUTSIZE": [n1, *stamp],
                                                    "PAD": 1, "INPAD": inpad,
                                                    "NPIXPSF": npixpsf, "STOP": 0})
    inject_stripes(work, raw_images(work))
    cfg = dict(cfg, DSOUT=[str(work / "ds"), "ds"],
               DSOBSFILE=str(work / "in" / "sim_L2_*[0-9].fits"))
    (work / MARKER).write_text(json.dumps(cfg))
    return cfg


def destripe_quality(root, raw, dsdir):
    """Per exposure, the std of the row medians of (striped - clean) and of
    (destriped - clean) (tests/test_full_pipeline.py's criterion); reads
    the striped images from `raw`, so call it before they are replaced."""
    from .fitsio import fits_read

    out = {}
    for p in raw:
        name = _L2.search(Path(p).name).group(0)
        clean = np.asarray(fits_read(Path(root) / "clean" / Path(p).name)[0].data, np.float64)
        striped = np.asarray(fits_read(p)[0].data, np.float64)
        ds = np.asarray(fits_read(Path(dsdir) / f"ds_{name}.fits")[0].data, np.float64)
        out[name] = {"striped": float(np.std(np.median(striped - clean, axis=1))),
                     "destriped": float(np.std(np.median(ds - clean, axis=1)))}
    return out


def destripe(cfg, maxiter=5, device="cuda", map_dtype="f64", memmap=False):
    """Stage 1: imdestripe.main (no object mask, no WCS gain, as the script
    runs it; `map_dtype` and `memmap` choose the pair maps' storage), then
    each destriped exposure written back under its L2 name; returns
    destripe_quality of every exposure."""
    from . import imdestripe
    from .config import Config
    from .fitsio import HDUList, Header, ImageHDU, fits_read, fits_write

    work = Path(cfg["DSOUT"][0]).parent
    imdestripe.main(Config(dict(cfg)), maxiter=maxiter, add_objmask=False,
                    use_wcs_gain=False, device=device, map_dtype=map_dtype, memmap=memmap)
    raw = raw_images(work)
    dsdir = cfg["DSOUT"][0]
    quality = destripe_quality(work, raw, dsdir)
    for p in raw:
        g = fits_read(Path(dsdir) / f"ds_{_L2.search(Path(p).name).group(0)}.fits")
        fits_write(p, HDUList([ImageHDU(np.asarray(g[0].data, np.float32),
                                        header=Header(g[0].header))]))
    return quality


def layers(cfg, device="cuda"):
    """Stage 2: the input layer caches of every exposure
    (layer_wrapper.build_all_layers); returns its results."""
    from .config import Config
    from .layer_wrapper import build_all_layers

    return build_all_layers(Config(dict(cfg)), device=device)


def coadd(cfg, device="cuda"):
    """Stage 3: every block of the mosaic; returns {output path: seconds}."""
    from .coadd import Block
    from .config import Config

    out = {}
    for sub in range(cfg["BLOCK"] ** 2):
        t0 = time.perf_counter()
        blk = Block(cfg=Config(dict(cfg)), this_sub=sub, device=device)
        out[blk.outstem + ".fits"] = time.perf_counter() - t0
    return out


def halo_exchange(cfg):
    """Stage 4: the padding-stamp halo exchange over the mosaic, every block
    saved back to its file (runner.share_pads; the script discards its
    exchange, so its compress stage packs the blocks as coadded); returns
    the number of blocks."""
    from .runner import share_pads

    return share_pads(cfg["OUT"])


def compress(cfg):
    """Stage 5: layers 1 and up of every block file to ``.cpr.fits.gz``
    (layer_wrapper.compress_all_blocks); returns the written paths."""
    from .config import Config
    from .layer_wrapper import compress_all_blocks

    outs = compress_all_blocks(Config(dict(cfg)))
    if not outs:
        raise RuntimeError("compression wrote no block file")
    return outs


def make_report(cfg, stem, ds_dir=None):
    """Stage 6: the validation report of block _00_01 (diagnostics.run.
    run_report) into ``stem_report.pdf`` and ``stem_data.txt``, with the
    row stability of the destriped exposures in `ds_dir` (default the
    run's DSOUT directory); returns (the PDF's path, the datablocks' names)."""
    from .diagnostics.report import pull_from_file
    from .diagnostics.run import run_report

    ds_dir = cfg["DSOUT"][0] if ds_dir is None else ds_dir
    pdf = run_report(cfg["OUT"] + "_00_01.fits", str(stem), ds_dir=str(ds_dir),
                     ds_pattern=DS_PATTERN)
    if not Path(pdf).exists():
        raise RuntimeError(f"the report wrote no PDF {pdf}")
    blocks = pull_from_file(str(stem) + "_data.txt")
    if not blocks:
        raise RuntimeError("the report wrote no datablocks")
    return pdf, sorted(blocks)


def compression_check(block, packed):
    """A compressed block read back through compress.ReadFile against the
    block file: for every layer it compressed (1 and up), the largest error
    and its bound; for every other HDU whether it reads back equal (ReadFile
    adds the CPRESS table of the scheme's parameters).  The bound is that of
    I24B's arithmetic: half the quantization step q = (VMAX - VMIN) / 2^24
    from the floor and its half-step decode, plus the float32 roundings of
    the encoder -- of x - VMIN (half a float32 spacing at VMAX - VMIN) and of
    the division by VMAX - VMIN (q / 2) -- and of the decoded value (half a
    spacing at max(|VMIN|, |VMAX|))."""
    from .compress import ReadFile
    from .fitsio import fits_read
    from .layer_wrapper import I24B_PARS

    orig, back = fits_read(block), ReadFile(packed)
    vmin, vmax = float(I24B_PARS["VMIN"]), float(I24B_PARS["VMAX"])
    q = (vmax - vmin) / 2 ** 24
    bound = q + 0.5 * float(np.spacing(np.float32(vmax - vmin))
                            + np.spacing(np.float32(max(abs(vmin), abs(vmax)))))
    a, b = np.asarray(orig[0].data), np.asarray(back[0].data)
    err = {}
    for il in range(1, a.shape[1]):
        x, y = a[:, il].astype(np.float64), b[:, il].astype(np.float64)
        err[il] = {"max_abs_err": float(np.abs(x - y).max()), "bound": bound}
    same = {"PRIMARY layer 0": bool(np.array_equal(a[:, 0], b[:, 0]))}
    names = [h.name for h in orig[1:]]
    for name in names:
        ho, hb = orig[name], back[name]
        if isinstance(ho.data, dict):
            same[name] = list(ho.data) == list(hb.data) and all(
                np.array_equal(np.asarray(ho.data[c]), np.asarray(hb.data[c])) for c in ho.data)
        else:
            same[name] = bool(np.array_equal(np.asarray(ho.data), np.asarray(hb.data)))
    same["HDU names"] = [h.name for h in back] == [h.name for h in orig] + ["CPRESS"]
    return {"layers": err, "equal": same}


def star_quality(path, cfg):
    """(SL1, VAR) of the science star in layer 0 of a block against the
    target Gaussian at the run's output pixel scale (the script's fixture
    constants are for 0.04" pixels)."""
    from .fitsio import fits_read
    from .wcsutil import WCS

    fx = _fixture()
    scale = cfg["OUTSIZE"][2]
    sig = cfg["EXTRASMOOTH"] * 0.11 / scale           # target sigma, output pixels
    sc = (scale / 0.11) ** 2                           # output / input pixel area
    f = fits_read(path)
    xs, ys = WCS.from_header(f[0].header).world2pix(fx.SRA, fx.SDEC)
    d = np.asarray(f[0].data[0, 0], np.float64)
    y, x = np.mgrid[0:d.shape[0], 0:d.shape[1]]
    p = np.exp(-0.5 * ((x - float(xs)) ** 2 + (y - float(ys)) ** 2) / sig ** 2) \
        / (2 * np.pi * sig ** 2 * sc)
    SL1 = float(np.sum(p * d) / np.sum(p ** 2))
    VAR = float(np.sum((d - SL1 * p) ** 2) / np.sum(p ** 2))
    return SL1, VAR


def run(work, n_obs=8, maxiter=5, n1=8, npixpsf=48, inpad=1.055, device="cuda",
        report=True):
    """Every stage in order (the report only with `report`); returns the
    result line as a dict."""
    import torch

    from .bench import card_label, uc_median
    from .device import resolve_device

    resolve_device(device)          # no card raises here, before the host work
    if report:
        import matplotlib  # noqa: F401 - the report needs it; fail before the stages
    work = Path(work)
    if (work / MARKER).exists():
        shutil.rmtree(work)
    elif work.exists() and any(work.iterdir()):
        raise FileExistsError(f"{work} holds files of no pipeline run")
    stages, launches = {}, {}

    def stage(name, fn, *args, **kw):
        print(f"[pipeline] stage {name} ...", flush=True)
        before = _launches()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        launches[name] = {k: v - before[k] for k, v in _launches().items()}
        print(f"[pipeline] stage {name}: {stages[name]:.2f} s", flush=True)
        return out

    cfg = stage("build", build, work, n_obs, n1, npixpsf, inpad)
    quality = stage("destripe", destripe, cfg, maxiter, device)
    built = stage("layers", layers, cfg, device)
    # the layer builds launch K1 in the pool's workers, which count their own
    launches["layers"]["interp_d5512_dense"] = sum(r[2] for r in built)
    blocks = stage("coadd", coadd, cfg, device)
    stage("halo_exchange", halo_exchange, cfg)
    stage("compress", compress, cfg)
    pdf = datablocks = None
    if report:
        pdf, datablocks = stage("report", make_report, cfg, work / "rep")

    out01 = cfg["OUT"] + "_00_01.fits"
    SL1, VAR = star_quality(out01, cfg)
    scale = cfg["OUTSIZE"][2]
    return {
        "metric": "chained_pipeline_wall_s", "value": sum(stages.values()),
        "unit": (f"build->destripe->layers->coadd({cfg['BLOCK']}x{cfg['BLOCK']} blocks of "
                 f"{n1}x{n1} {STAMP_PX}px-stamps at {scale}\", PAD 1, NPIXPSF {npixpsf}, "
                 f"INPAD {inpad}\")->halo->compress on {card_label(device)}"),
        "stages_s": stages, "coadd_block_s": blocks, "launches": launches,
        "exposures": len(built), "destripe_row_median_std": quality,
        "destriped_2x": sum(q["destriped"] < 0.5 * q["striped"] for q in quality.values()),
        "star_SL1": SL1, "star_VAR": VAR, "UC_median": uc_median(out01),
        "UC_median_blocks": {Path(p).name: uc_median(p) for p in blocks},
        "compression": {Path(p).name: compression_check(p, p[:-5] + ".cpr.fits.gz")
                        for p in blocks},
        "report_pdf": pdf, "report_datablocks": datablocks,
        "card": card_label(device),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description="pyimcom_tpu_torch chained pipeline")
    ap.add_argument("--workdir", default=str(WORK))
    ap.add_argument("--n-obs", type=int, default=8)
    ap.add_argument("--maxiter", type=int, default=5, help="destripe CG iterations")
    ap.add_argument("--n1", type=int, default=8,
                    help="stamps per block side (production blocks use 80)")
    ap.add_argument("--npixpsf", type=int, default=48, help="PSF postage size")
    ap.add_argument("--inpad", type=float, default=1.055)
    ap.add_argument("--artifact", default=None, help="also write the JSON line here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--no-report", action="store_true",
                    help="leave out the report stage (it needs matplotlib)")
    args = ap.parse_args(argv)
    result = run(args.workdir, args.n_obs, args.maxiter, args.n1, args.npixpsf,
                 args.inpad, args.device, report=not args.no_report)
    text = json.dumps(result)
    if args.artifact:
        Path(args.artifact).write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
