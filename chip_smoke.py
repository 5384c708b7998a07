#!/usr/bin/env python3
"""
Smoke run of pyimcom_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA GPU

It builds the port's CUDA kernels from csrc/ and drives the port's paths
through the user's entry points: the block coadd
``pyimcom_tpu_torch.coadd.Block(cfg, this_sub, device="cuda")`` with every
LAKERNEL, and the toolchain probe ``pyimcom_tpu_torch.probe``:

1. build: the card's name and power limit, the nvcc build of the D5512
   kernels;
2. probe: the probe entry point builds csrc/probe.cu and launches its
   kernel on an (8, 128) float32 tensor (its own path: counts reset before,
   read after);
3. kernels: each kernel against its plain PyTorch version on the card, on
   seeded inputs at its path's shapes (criterion: 1e-12 of scale in f64,
   exact for the probe), with median CUDA-event times of both;
4. bench_block: BASELINE.json configs[0] (8 exposures, cstar14, all 16
   stamps of block 1) -- a cold run that builds the input layers, then the
   measured warm run: blocks/hour, phase times, SL1, the U/C median, and the
   kernel launch counts of that run;
5. eigen_block: configs[1], LAKERNEL Eigen at KAPPAC [5e-4, 1e-3, 2e-3],
   all 16 stamps, warm: blocks/hour, phase times, SL1 (|SL1-1| < 1e-3), the
   U/C median and the launch counts;
6. solver_cross: STOP 2 with single- and multi-kappa Cholesky, Eigen,
   Iterative and Empirical, compared in the star stamp [0:25, 25:50] at the
   bounds of tests/test_e2e_kernels.py, with each solver's solve-phase time;
7. production_group / production_iterative / production_eigen: one 2x2
   group at production geometry (OUTSIZE [80, 32, 0.0390625], INPAD 1.055,
   NPIXPSF 48) with Cholesky, with the production default solve of
   configs/default_config.json (Iterative, KAPPAC [0.0], ITERRTOL 0.0015,
   ITERMAX 30) and with Eigen: seconds per stamp, n per stamp, peak device
   memory, U/C and Sigma medians; every output map must be finite;
8. galaxy_block: a gsext14 galaxy layer (n=0.5, hlr=0.1, shape=0.2:0.1) at
   STOP 4, cold: adaptive moments against the analytic covariance (5e-4
   arcsec^2), the flux (0.97-1.03), the cold input time and the K1 launches
   of the injection (cold minus warm run; above 0).

Every block runs with the kernel launch counts set to 0 just before it and
read just after, and fails if a kernel of its path was not launched.  Each
phase prints one JSON line.  Then come the kernel summary line, the
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
EIGEN_SL1_TOL = 1e-3            # tests/test_e2e_kernels.py, the Eigen runs
CPU_RECORD = {"SL1": 0.999938, "uc_median": 3.65e-7}   # .bench_cpu_baseline.json
MULTI_KAPPA = [5e-4, 1e-3, 2e-3]                        # BASELINE.json configs[1]
STAR_REGION = np.s_[0:25, 25:50]                        # the stamp with the star
PROD = dict(OUTSIZE=[80, 32, 0.0390625], INPAD=1.055, NPIXPSF=48, STOP=4)
GALAXY = "gsext14,n=0.5,hlr=0.1,shape=0.2:0.1"          # tests/test_e2e_galaxy.py


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

    # the probe kernel at its entry point's shape; exact in f32
    from pyimcom_tpu_torch import probe

    xp = torch.as_tensor(rng.normal(size=(8, 128)), dtype=torch.float32, device=dev)
    got, want = probe.probe_add_one(xp), probe.probe_add_one_plain(xp)
    torch.cuda.synchronize()
    out["probe"] = dict(shape=[8, 128], max_abs_err=float((got - want).abs().max()),
                        ms=median_ms(torch, lambda: probe.probe_add_one(xp), 20),
                        plain_ms=median_ms(torch, lambda: probe.probe_add_one_plain(xp), 20))
    assert out["probe"]["max_abs_err"] == 0.0, out["probe"]
    return out


def science(path):
    """Layer 0 of output PSF 0 of a block, in float64."""
    from pyimcom_tpu.fitsio import fits_read

    return np.asarray(fits_read(path)[0].data[0, 0], dtype=np.float64)


def quality_check(path):
    """Star recovery SL1 and the U/C median of a bench block (the same
    decoding as bench.quality_check)."""
    from pyimcom_tpu.fitsio import fits_read
    from pyimcom_tpu.wcsutil import WCS

    f = fits_read(path)
    w = WCS.from_header(f[0].header)
    xs, ys = w.world2pix(60.0508, -3.8005)
    d = science(path)
    sig = 0.9265328730414752 * 0.11 / 0.04
    sc = (0.04 / 0.11) ** 2
    yy, xx = np.mgrid[0:d.shape[0], 0:d.shape[1]]
    p = np.exp(-0.5 * ((xx - float(xs)) ** 2 + (yy - float(ys)) ** 2) / sig ** 2) \
        / (2 * np.pi * sig ** 2 * sc)
    region = STAR_REGION
    SL1 = float(np.sum((p * d)[region]) / np.sum((p ** 2)[region]))
    fid = np.asarray(f["FIDELITY"].data, dtype=np.float64)
    uc = 10.0 ** (fid / -5000.0)
    # exclude encodings of exactly-zero U/C (never-coadded pixels saturate)
    good = (uc > 1e-10) & (uc < 0.5)
    uc_med = float(np.median(uc[good])) if np.any(good) else 1.0
    return SL1, uc_med


def run_block(cfg_dict, suffix, **over):
    """One Block on the card, with the kernel launch counts set to 0 just
    before it and read just after; returns (block, output path, seconds,
    launches)."""
    import torch

    from pyimcom_tpu.config import Config
    from pyimcom_tpu_torch.coadd import Block
    from pyimcom_tpu_torch.ops import interp_cuda

    d = dict(cfg_dict, **over)
    d["OUT"] = d["OUT"] + suffix
    torch.cuda.synchronize()
    interp_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    blk = Block(cfg=Config(d), this_sub=1, device="cuda")
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    launches = dict(interp_cuda.launches)
    assert all(n > 0 for n in launches.values()), (suffix, launches)
    return blk, d["OUT"] + "_00_01.fits", t, launches


def phase_times(blk):
    return {k: {"host_s": round(v["host_s"], 4), "device_ms": round(v["device_ms"], 3),
                "calls": v["calls"]} for k, v in blk.phase_times().items()}


def solve_ms_per_stamp(blk):
    """CUDA-event milliseconds of the solve phase per coadded stamp."""
    return blk.phase_times()["stamp.solve"]["device_ms"] / max(len(blk.stamp_stats), 1)


def run_production(torch, dev, cfg_dict, phase, suffix, **over):
    """One 2x2 group at production geometry; prints its phase line."""
    from pyimcom_tpu.fitsio import fits_read

    torch.cuda.reset_peak_memory_stats(dev)
    prod, out_p, t_prod, launches = run_block(cfg_dict, suffix, **PROD, **over)
    hdus = fits_read(out_p)
    maps = {h.header.get("EXTNAME") or "SCI": np.asarray(h.data) for h in hdus
            if getattr(h, "data", None) is not None and np.asarray(h.data).dtype.kind in "fiu"
            and np.asarray(h.data).ndim >= 2}
    finite = {k: bool(np.all(np.isfinite(v))) for k, v in maps.items()}
    emit({"phase": phase, "solve": over or "Cholesky", "stamps": len(prod.stamp_stats),
          "block_s": t_prod, "s_per_stamp": t_prod / max(len(prod.stamp_stats), 1),
          "solve_ms_per_stamp": solve_ms_per_stamp(prod),
          "n": [s["n"] for s in prod.stamp_stats],
          "uc_median": [s["uc_median"] for s in prod.stamp_stats],
          "sigma_median": [s["sigma_median"] for s in prod.stamp_stats],
          "max_memory_allocated_GiB": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
          "finite": finite, "launches": launches, "phases": phase_times(prod)})
    assert len(prod.stamp_stats) == 4 and all(finite.values()), finite


def galaxy_moments(path):
    """Adaptive moments of the brightest galaxy of layer 1 against the
    analytic covariance of target PSF + sheared galaxy (in arcsec^2), and
    its flux (tests/test_e2e_galaxy.py)."""
    from survey_fixture import SIG_OUT

    from pyimcom_tpu.fitsio import fits_read
    from pyimcom_tpu.layer import _shear_matrix
    from pyimcom_tpu.utils.moments import find_adaptive_moments
    from pyimcom_tpu.wcsutil import WCS, local_partial_pixel_derivatives2

    f = fits_read(path)
    img = np.asarray(f[0].data[0, 1])
    iy, ix = np.unravel_index(np.argmax(img), img.shape)
    win = 12
    assert win <= ix < img.shape[1] - win and win <= iy < img.shape[0] - win, (ix, iy)
    sub = np.asarray(img[iy - win:iy + win + 1, ix - win:ix + win + 1], dtype=np.float64)
    m = find_adaptive_moments(sub, guess_sigma=3.0)
    sigma_gal = 0.1 / np.sqrt(2 * np.log(2))
    M = _shear_matrix(0.2, 0.1)
    Jout = local_partial_pixel_derivatives2(WCS.from_header(f[0].header),
                                            float(ix), float(iy)) * 3600.0
    B = np.linalg.inv(Jout)
    want = SIG_OUT ** 2 * np.eye(2) + B @ (sigma_gal ** 2 * (M @ M.T)) @ B.T
    got = np.array([[m.Mxx, m.Mxy], [m.Mxy, m.Myy]])
    diff = np.abs(got - want) * 0.04 ** 2            # output pixel 0.04"
    return dict(converged=bool(m.converged), moments_px2=got.ravel().tolist(),
                analytic_px2=want.ravel().tolist(),
                max_diff_arcsec2=float(diff.max()),
                flux=float(sub.sum() * (0.04 / 0.11) ** 2))


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

    t0 = time.perf_counter()
    report = _build.build("interp_d5512")
    _build.library("interp_d5512")
    emit({"phase": "build", "gpu": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": time.perf_counter() - t0,
          "ptxas": [ln.strip() for ln in report.splitlines()
                    if "registers" in ln or "spill" in ln]})

    # ---- 2. the probe entry point ---------------------------------------------
    from pyimcom_tpu_torch import probe

    probe.reset_launch_counts()
    verdict = probe.run()
    probe_launches = probe.launches["probe_add_one"]
    emit({"phase": "probe", **verdict, "launches": probe_launches})
    assert verdict["ok"] and probe_launches > 0, verdict

    # ---- 3. kernels vs plain versions -----------------------------------------
    kern = phase_kernels(torch, dev)
    emit({"phase": "kernels", "criterion": TOL, **kern})

    # ---- 4. the bench block ---------------------------------------------------
    from survey_fixture_torch import build_survey

    shutil.rmtree(WORK, ignore_errors=True)
    cfg_dict = build_survey(WORK, n_obs=8, extrainput=["cstar14"])
    blk_cold, _out, t_cold, _launches = run_block(cfg_dict, "_cold")
    blk, out, t_block, launches = run_block(cfg_dict, "_bench")
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

    # ---- 5. configs[1]: Eigen with a kappa sweep, warm --------------------------
    eig, out_e, t_eig, eig_launches = run_block(cfg_dict, "_eigen", LAKERNEL="Eigen",
                                                KAPPAC=MULTI_KAPPA)
    SL1_e, uc_e = quality_check(out_e)
    emit({"phase": "eigen_block", "stamps": len(eig.stamp_stats), "block_s": t_eig,
          "blocks_per_hour": 3600.0 / t_eig, "SL1": SL1_e, "uc_median": uc_e,
          "solve_ms_per_stamp": solve_ms_per_stamp(eig), "launches": eig_launches,
          "phases": phase_times(eig)})
    assert len(eig.stamp_stats) == 16, eig.stamp_stats
    assert abs(SL1_e - 1.0) < EIGEN_SL1_TOL, SL1_e

    # ---- 6. every solver at STOP 2, in the star stamp -------------------------
    variants = {"chol": {}, "multik": dict(KAPPAC=MULTI_KAPPA),
                "eigen": dict(LAKERNEL="Eigen", KAPPAC=MULTI_KAPPA),
                "iter": dict(LAKERNEL="Iterative", ITERRTOL=1.5e-3, ITERMAX=30),
                "empir": dict(LAKERNEL="Empirical")}
    img, solve_ms, cross_launches = {}, {}, {}
    for name, over in variants.items():
        blk_v, out_v, _t, cross_launches[name] = run_block(cfg_dict, "_x" + name, STOP=2,
                                                           **over)
        img[name] = science(out_v)[STAR_REGION]
        solve_ms[name] = solve_ms_per_stamp(blk_v)

    def diff(a, b):
        d = img[a] - img[b]
        return {"std": float(np.std(d)), "mean": float(np.mean(d))}

    cross = {f"{a}-{b}": diff(a, b) for a, b in
             (("chol", "multik"), ("multik", "eigen"), ("chol", "iter"), ("eigen", "iter"),
              ("chol", "empir"), ("eigen", "empir"))}
    signal_std = float(np.std(img["chol"]))
    emit({"phase": "solver_cross", "stop": 2, "region": "[0:25, 25:50]", "diff": cross,
          "signal_std": signal_std, "solve_ms_per_stamp": solve_ms,
          "launches": cross_launches})
    for pair in ("chol-multik", "multik-eigen"):
        assert cross[pair]["std"] < 3e-5 and abs(cross[pair]["mean"]) < 2e-6, (pair, cross)
    assert cross["chol-iter"]["std"] < 2.5e-3, cross
    assert cross["chol-empir"]["std"] < 1.05 * signal_std, cross
    assert all(np.all(np.isfinite(v)) for v in img.values())

    # ---- 7. production geometry: one 2x2 group, three solvers -----------------
    run_production(torch, dev, cfg_dict, "production_group", "_prod")
    run_production(torch, dev, cfg_dict, "production_iterative", "_prodit",
                   LAKERNEL="Iterative", KAPPAC=[0.0], ITERRTOL=0.0015, ITERMAX=30)
    run_production(torch, dev, cfg_dict, "production_eigen", "_prodeig",
                   LAKERNEL="Eigen", KAPPAC=MULTI_KAPPA)

    # ---- 8. galaxy injection: gsext14 at STOP 4, cold then warm ----------------
    (WORK / "cache_gal").mkdir()
    gal = dict(EXTRAINPUT=[GALAXY], STOP=4,
               INLAYERCACHE=str(WORK / "cache_gal" / "in"))
    gal_cold, out_g, t_gal, gal_launches = run_block(cfg_dict, "_gal", **gal)
    _blk, _out, _t, warm_launches = run_block(cfg_dict, "_galwarm", **gal)
    k1_injection = (gal_launches["interp_d5512_dense"]
                    - warm_launches["interp_d5512_dense"])
    mom = galaxy_moments(out_g)
    emit({"phase": "galaxy_block", "layer": GALAXY, "stamps": len(gal_cold.stamp_stats),
          "block_s": t_gal,
          "cold_inputs_s": gal_cold.phase_times()["block.inputs"]["host_s"],
          "launches": gal_launches, "K1_launches_injection": k1_injection, **mom})
    assert mom["converged"] and mom["max_diff_arcsec2"] < 5e-4, mom
    assert 0.97 < mom["flux"] < 1.03, mom
    assert k1_injection > 0, k1_injection

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
         "ms": kern["K2_pool"]["ms"], "plain_ms": kern["K2_pool"]["plain_ms"]},
        {"name": "probe_add_one", "route": "cuda", "source": "pyimcom_tpu_torch/csrc/probe.cu",
         "replaces": "scripts/probe_pallas.py:33", "launches": probe_launches,
         "max_abs_err": kern["probe"]["max_abs_err"], "ms": kern["probe"]["ms"],
         "plain_ms": kern["probe"]["plain_ms"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
