#!/usr/bin/env python3
"""
Smoke run of pyimcom_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA GPU

It builds the port's CUDA kernels from csrc/ and drives the port's main
path, the Cholesky block coadd, through the user's entry point
``pyimcom_tpu_torch.coadd.Block(cfg, this_sub, device="cuda")``:

1. device and build: the card's name and power limit, the nvcc build time;
2. each kernel against its plain PyTorch version on the card, on seeded
   inputs at the main path's shapes (criterion: 1e-12 of scale in f64), with
   median CUDA-event times of kernel and plain version;
3. the bench block (BASELINE.json configs[0]: 8 exposures, cstar14, all 16
   stamps of block 1) -- a cold run that builds the input layers, then the
   measured warm run: blocks/hour, phase times, SL1, the U/C median, and the
   kernel launch counts of that run (both must be above 0);
4. one 2x2 group at production geometry (OUTSIZE [80, 32, 0.0390625],
   INPAD 1.055, NPIXPSF 48): seconds per stamp, n per stamp, peak device
   memory, U/C and Sigma medians; every output map must be finite.

Each phase prints one JSON line.  Then come the kernel summary line, the
``nvidia-smi`` name / power-limit line, and as the last line
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
without that line; so does a machine without CUDA.  The survey is written
under .smoke_work/ in the repository (git-ignored) and rebuilt every run.
"""

import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
WORK = REPO / ".smoke_work"
TOL = 1e-12                     # kernel vs plain, of scale, f64
SL1_TOL, UC_MAX = 5e-4, 1e-6    # reference CI thresholds
CPU_RECORD = {"SL1": 0.999938, "uc_median": 3.65e-7}   # .bench_cpu_baseline.json


def emit(obj):
    print(json.dumps(obj), flush=True)


def gpu_name_and_power():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def median_ms(torch, fn, reps, setup=None):
    """Median CUDA-event time of fn() over `reps` calls, after 2 warm-ups."""
    times = []
    for i in range(reps + 2):
        if setup is not None:
            setup()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        if i >= 2:
            times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def rel_err(torch, got, want):
    scale = float(want.abs().max())
    assert scale > 0, "reference output is all zero"
    return float((got - want).abs().max()) / scale


def phase_kernels(torch, dev):
    """K1 and K2 against their plain versions at main-path shapes."""
    from pyimcom_tpu_torch.ops import interp_cuda as ic
    from pyimcom_tpu_torch.psfgrp import _DENSE_RBATCH_BY_BUCKET

    rng = np.random.default_rng(20261016)
    ns = 263                              # bench overlap image: novl + 12
    out = {}

    # K1: R x Nq = 32 x 16384 (a chunk of star patches, 128^2 each)
    R, Nq = 32, 16384
    images = torch.as_tensor(rng.normal(size=(R, ns, ns)), device=dev)
    x = torch.as_tensor(rng.uniform(0, ns, (R, Nq)), device=dev)
    y = torch.as_tensor(rng.uniform(0, ns, (R, Nq)), device=dev)
    got = ic.interp_d5512_dense(images, x, y)
    want = ic.interp_d5512_dense_plain(images, x, y)
    torch.cuda.synchronize()
    out["K1"] = dict(shape=[R, Nq, ns, ns], max_abs_err=rel_err(torch, got, want),
                     ms=median_ms(torch, lambda: ic.interp_d5512_dense(images, x, y), 20),
                     plain_ms=median_ms(torch, lambda: ic.interp_d5512_dense_plain(
                         images, x, y), 5))

    # K2: one sweep batch, bucket 16384 x rbatch 32, over a 64-image stack
    bucket = 16384
    rows = _DENSE_RBATCH_BY_BUCKET[bucket]
    K, L = 64, 6000
    combined = torch.as_tensor(rng.normal(size=(K, ns, ns)), device=dev)
    xt_np, yt_np = rng.uniform(0, 60, L), rng.uniform(0, 60, L)
    xt, yt = torch.as_tensor(xt_np, device=dev), torch.as_tensor(yt_np, device=dev)
    inv_scale, off_grid = 2.18, 131.0      # bench: 1/dscale, nc_ovl + INTERP_PAD
    ks = rng.integers(0, K, rows).astype(np.int32)

    def meta(w2s):
        w1s = -(-bucket // w2s)
        i1 = rng.integers(0, L - w1s.max(), rows)
        i2 = rng.integers(0, L - w2s.max(), rows)
        nval = np.minimum(bucket, w1s * w2s)
        return np.stack([i1, i2, w2s, np.zeros(rows, int), nval], 1).astype(np.int32), nval

    # pool mode: each row fills its own (w1, w2) submatrix region
    w2s = rng.integers(60, 400, rows)
    im_p, nval = meta(w2s)
    base = np.concatenate([[0], np.cumsum(nval)])[:-1]
    pmeta = np.stack([base, w2s, w2s, np.zeros(rows, int), nval], 1).astype(np.int32)
    P = int(nval.sum())
    # B mode (m = 729 bench output grid): each row fills its own columns
    m = 729
    w1b = bucket // m
    im_b, nval_b = meta(np.full(rows, m))
    im_b[:, 4] = nval_b = np.full(rows, w1b * m)
    n_pad = rows * w1b
    bmeta = np.stack([np.zeros(rows, int), np.arange(rows) * w1b,
                      np.zeros(rows, int), nval_b], 1).astype(np.int32)

    def put(a):
        return torch.as_tensor(a, device=dev)

    args = {0: (put(ks), put(im_p), put(pmeta)), 1: (put(ks), put(im_b), put(bmeta))}
    size = {0: P, 1: m * n_pad}
    for mode, name in ((0, "K2_pool"), (1, "K2_B")):
        dst_k = torch.zeros(size[mode], dtype=torch.float64, device=dev)
        dst_p = torch.zeros_like(dst_k)
        kw = dict(bucket=bucket, mode=mode, n_pad=n_pad, m=m)
        ic.sweep_d5512_scatter(dst_k, combined, xt, yt, *args[mode], inv_scale, off_grid, **kw)
        ic.sweep_d5512_scatter_plain(dst_p, combined, xt, yt, *args[mode], inv_scale,
                                     off_grid, **kw)
        torch.cuda.synchronize()
        out[name] = dict(
            shape=[rows, bucket, K, ns, ns], queries=int(np.count_nonzero(
                (dst_p != 0).cpu().numpy())),
            max_abs_err=rel_err(torch, dst_k, dst_p),
            ms=median_ms(torch, lambda: ic.sweep_d5512_scatter(
                dst_k, combined, xt, yt, *args[mode], inv_scale, off_grid, **kw), 20,
                setup=dst_k.zero_),
            plain_ms=median_ms(torch, lambda: ic.sweep_d5512_scatter_plain(
                dst_p, combined, xt, yt, *args[mode], inv_scale, off_grid, **kw), 5,
                setup=dst_p.zero_))
    for name, rec in out.items():
        assert rec["max_abs_err"] < TOL, (name, rec)
    return out


def quality_check(path):
    """Star recovery SL1 and the U/C median of a bench block (the same
    decoding as bench.quality_check)."""
    from pyimcom_tpu.fitsio import fits_read
    from pyimcom_tpu.wcsutil import WCS

    f = fits_read(path)
    w = WCS.from_header(f[0].header)
    xs, ys = w.world2pix(60.0508, -3.8005)
    d = np.asarray(f[0].data[0, 0], dtype=np.float64)
    sig = 0.9265328730414752 * 0.11 / 0.04
    sc = (0.04 / 0.11) ** 2
    yy, xx = np.mgrid[0:d.shape[0], 0:d.shape[1]]
    p = np.exp(-0.5 * ((xx - float(xs)) ** 2 + (yy - float(ys)) ** 2) / sig ** 2) \
        / (2 * np.pi * sig ** 2 * sc)
    region = np.s_[0:25, 25:50]
    SL1 = float(np.sum((p * d)[region]) / np.sum((p ** 2)[region]))
    fid = np.asarray(f["FIDELITY"].data, dtype=np.float64)
    uc = 10.0 ** (fid / -5000.0)
    # exclude encodings of exactly-zero U/C (never-coadded pixels saturate)
    good = (uc > 1e-10) & (uc < 0.5)
    uc_med = float(np.median(uc[good])) if np.any(good) else 1.0
    return SL1, uc_med


def run_block(cfg_dict, suffix, **over):
    """One Block on the card; returns (block, output path, seconds)."""
    import torch

    from pyimcom_tpu.config import Config
    from pyimcom_tpu_torch.coadd import Block

    d = dict(cfg_dict, **over)
    d["OUT"] = d["OUT"] + suffix
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blk = Block(cfg=Config(d), this_sub=1, device="cuda")
    torch.cuda.synchronize()
    return blk, d["OUT"] + "_00_01.fits", time.perf_counter() - t0


def phase_times(blk):
    return {k: {"host_s": round(v["host_s"], 4), "device_ms": round(v["device_ms"], 3),
                "calls": v["calls"]} for k, v in blk.phase_times().items()}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(REPO), str(REPO / "tests")]
    dev = torch.device("cuda", 0)
    smi = gpu_name_and_power()

    # ---- 1. device and build ------------------------------------------------
    from pyimcom_tpu_torch import _build
    from pyimcom_tpu_torch.ops import interp_cuda

    t0 = time.perf_counter()
    report = _build.build("interp_d5512")
    _build.library("interp_d5512")
    emit({"phase": "build", "gpu": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": time.perf_counter() - t0,
          "ptxas": [ln.strip() for ln in report.splitlines()
                    if "registers" in ln or "spill" in ln]})

    # ---- 2. kernels vs plain versions ---------------------------------------
    kern = phase_kernels(torch, dev)
    emit({"phase": "kernels", "criterion": TOL, **kern})

    # ---- 3. the bench block ---------------------------------------------------
    from survey_fixture_torch import build_survey

    shutil.rmtree(WORK, ignore_errors=True)
    cfg_dict = build_survey(WORK, n_obs=8, extrainput=["cstar14"])
    blk_cold, _out, t_cold = run_block(cfg_dict, "_cold")
    interp_cuda.reset_launch_counts()
    blk, out, t_block = run_block(cfg_dict, "_bench")
    launches = dict(interp_cuda.launches)
    SL1, uc_med = quality_check(out)
    emit({"phase": "bench_block", "stamps": len(blk.stamp_stats),
          "block_s": t_block, "blocks_per_hour": 3600.0 / t_block,
          "cold_block_s": t_cold, "cold_inputs_s": blk_cold.phase_times()["block.inputs"]["host_s"],
          "SL1": SL1, "uc_median": uc_med,
          "SL1_minus_cpu_record": SL1 - CPU_RECORD["SL1"],
          "uc_median_over_cpu_record": uc_med / CPU_RECORD["uc_median"],
          "launches": launches, "phases": phase_times(blk)})
    assert len(blk.stamp_stats) == 16, blk.stamp_stats
    assert abs(SL1 - 1.0) < SL1_TOL, SL1
    assert uc_med < UC_MAX, uc_med
    assert all(n > 0 for n in launches.values()), launches

    # ---- 4. production geometry: one 2x2 group -------------------------------
    torch.cuda.reset_peak_memory_stats(dev)
    prod, out_p, t_prod = run_block(cfg_dict, "_prod", OUTSIZE=[80, 32, 0.0390625],
                                    INPAD=1.055, NPIXPSF=48, STOP=4)
    from pyimcom_tpu.fitsio import fits_read

    hdus = fits_read(out_p)
    maps = {h.header.get("EXTNAME") or "SCI": np.asarray(h.data) for h in hdus
            if getattr(h, "data", None) is not None and np.asarray(h.data).dtype.kind in "fiu"
            and np.asarray(h.data).ndim >= 2}
    finite = {k: bool(np.all(np.isfinite(v))) for k, v in maps.items()}
    emit({"phase": "production_group", "stamps": len(prod.stamp_stats),
          "block_s": t_prod, "s_per_stamp": t_prod / max(len(prod.stamp_stats), 1),
          "n": [s["n"] for s in prod.stamp_stats],
          "uc_median": [s["uc_median"] for s in prod.stamp_stats],
          "sigma_median": [s["sigma_median"] for s in prod.stamp_stats],
          "max_memory_allocated_GiB": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
          "finite": finite, "phases": phase_times(prod)})
    assert len(prod.stamp_stats) == 4 and all(finite.values()), finite

    # ---- summary ---------------------------------------------------------------
    src = "pyimcom_tpu_torch/csrc/interp_d5512.cu"
    emit({"kernels": [
        {"name": "interp_d5512_dense", "route": "cuda", "source": src,
         "replaces": "pyimcom_tpu/ops/interp_pallas.py:85",
         "launches": launches["interp_d5512_dense"],
         "max_abs_err": kern["K1"]["max_abs_err"], "ms": kern["K1"]["ms"],
         "plain_ms": kern["K1"]["plain_ms"]},
        {"name": "sweep_d5512_scatter", "route": "cuda", "source": src,
         "replaces": "pyimcom_tpu/ops/interp_pallas.py:140",
         "launches": launches["sweep_d5512_scatter"],
         "max_abs_err": max(kern["K2_pool"]["max_abs_err"], kern["K2_B"]["max_abs_err"]),
         "ms": kern["K2_pool"]["ms"], "plain_ms": kern["K2_pool"]["plain_ms"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
