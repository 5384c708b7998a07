#!/usr/bin/env python3
"""
Smoke run of pyimcom_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA GPU

It builds the port's CUDA kernels from csrc/ and drives the port's paths
through the user's entry points: the block coadd
``pyimcom_tpu_torch.coadd.Block(cfg, this_sub, device="cuda")`` with every
LAKERNEL, and the toolchain probe ``pyimcom_tpu_torch.probe``:

1. build: the card's name and power limit, the nvcc builds of the D5512
   kernels (and, where pyimcom_tpu_torch/_build/parent/interp_d5512.cu
   holds that source as of commit 60e58e7 -- the one-thread-a-query K2 with
   a 20-argument C entry, pinned by its SHA-256 -- of that revision too),
   started together, with their ptxas register and spill lines;
2. probe: the probe entry point builds csrc/probe.cu and launches its
   kernel on an (8, 128) float32 tensor (its own path: counts reset before,
   read after);
3. kernels: each kernel against its plain PyTorch version on the card, on
   seeded inputs at its path's shapes (criterion: 1e-12 of scale in f64,
   exact for the probe), with median CUDA-event times of both and the
   kernel's bound;
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
8. k2_main_path: K2 on the sweep rows, overlap stack and coordinate tables
   of the first group of the warm bench block and of the Cholesky
   production group (captured while those blocks ran): every launch of each
   group timed alone and summed, against its plain version (1e-12 of
   scale), with its bound, the tiles it took from L2, and the earlier
   revision's K2 on the same inputs (also held to 1e-12 of scale) where the
   build phase built it;
9. galaxy_block: a gsext14 galaxy layer (n=0.5, hlr=0.1, shape=0.2:0.1) at
   STOP 4, cold: adaptive moments against the analytic covariance (5e-4
   arcsec^2), the flux (0.97-1.03), the cold input time and the K1 launches
   of the injection (cold minus warm run; above 0).

A bound is the least time the card could take for a kernel's work: the
larger of the bytes it must move (each input read once, each output written
once) over 3.35 TB/s and its f64 operations over 67 TFLOP/s (the H100 SXM
data sheet; the f64 rate is that of the tensor cores, twice the vector
units').

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
PARENT_SRC = REPO / "pyimcom_tpu_torch" / "_build" / "parent" / "interp_d5512.cu"
# pyimcom_tpu_torch/csrc/interp_d5512.cu at commit 60e58e7, the only
# revision whose C entry parent_k2() binds
PARENT_SHA256 = "ffd25aae2bd686e105523d8e22f3524184dd88838e28f5be649e004dc2b7e6b7"
PEAK_BYTES_S, PEAK_F64_S = 3.35e12, 67e12               # H100 SXM data sheet
TAPS_FLOP = 96                  # one D5512 tap set (Horner in fh^2)
QUERY_FLOP = 2 * TAPS_FLOP + 220 + 6   # two tap sets, the 10x10 sum, the position


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


def bound(bytes_, flops):
    """(bound ms, what sets it) of a kernel moving `bytes_` and doing `flops`."""
    t_b, t_f = bytes_ / PEAK_BYTES_S * 1e3, flops / PEAK_F64_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def k2_bound(mode, combined, xt, ks, imeta, dmeta, tiles, n2f, inv_scale):
    """Bound of one K2 launch: the overlap images its rows use, the tables,
    the metadata, and each destination read and written once; in pool mode
    QUERY_FLOP a query, in B mode the separable form's tap sets and
    horizontal and vertical sums."""
    from pyimcom_tpu_torch.ops.interp_cuda import b_window

    queries = int(imeta[:, 4].sum())
    images = len(np.unique(ks[imeta[:, 4] > 0]))
    ny, nx = combined.shape[1:]
    bytes_ = (8 * images * ny * nx + 16 * xt.shape[0] + 16 * queries
              + 4 * (ks.size + imeta.size + dmeta.size + tiles.size))
    if mode == 0:
        flops = QUERY_FLOP * queries
    else:
        m = n2f * n2f
        per_i1 = 2 * n2f * TAPS_FLOP + b_window(n2f, inv_scale) * n2f * 20 + m * 20
        flops = per_i1 * queries / m
    return bound(bytes_, flops)


def phase_kernels(torch, dev):
    """K1 and K2 against their plain versions on seeded random inputs at
    main-path shapes (K2's coordinates have none of the sweep's locality
    here: its pool tiles read from L2), and the probe kernel."""
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
    bound_ms, bound_by = bound(8 * (images.numel() + 3 * x.numel()), QUERY_FLOP * R * Nq)
    out["K1"] = dict(shape=[R, Nq, ns, ns], max_abs_err=rel_err(torch, got, want),
                     ms=median_ms(torch, lambda: ic.interp_d5512_dense(images, x, y), 20),
                     plain_ms=median_ms(torch, lambda: ic.interp_d5512_dense_plain(
                         images, x, y), 5), bound_ms=bound_ms, bound_by=bound_by)

    # K2: 32 rows of 16384 queries (the largest bucket's JAX batch) over a
    # 64-image stack; the B rows pair random pixels with a 27 x 27 output
    # lattice (the bench stamp's, m = 729)
    bucket = 16384
    rows = _DENSE_RBATCH_BY_BUCKET[bucket]
    K, L, n2f = 64, 6000, 27
    m = n2f * n2f
    combined = torch.as_tensor(rng.normal(size=(K, ns, ns)), device=dev)
    xt_np, yt_np = rng.uniform(0, 60, L), rng.uniform(0, 60, L)
    lat = L - m
    xt_np[lat:], yt_np[lat:] = 17.0 + np.arange(m) % n2f, 16.0 + np.arange(m) // n2f
    xt, yt = torch.as_tensor(xt_np, device=dev), torch.as_tensor(yt_np, device=dev)
    inv_scale, off_grid = 2.18, 131.0      # bench: 1/dscale, nc_ovl + INTERP_PAD
    ks = rng.integers(0, K, rows).astype(np.int32)

    def meta(w2s, i2):
        w1s = -(-bucket // w2s)
        i1 = rng.integers(0, lat - w1s.max(), rows)
        nval = np.minimum(bucket, w1s * w2s)
        return np.stack([i1, i2, w2s, np.zeros(rows, int), nval], 1).astype(np.int32), nval

    # pool mode: each row fills its own (w1, w2) submatrix region
    w2s = rng.integers(60, 400, rows)
    im_p, nval = meta(w2s, rng.integers(0, lat - w2s.max(), rows))
    base = np.concatenate([[0], np.cumsum(nval)])[:-1]
    pmeta = np.stack([base, w2s, w2s, np.zeros(rows, int), nval], 1).astype(np.int32)
    P = int(nval.sum())
    # B mode: each row fills its own columns
    w1b = bucket // m
    im_b, nval_b = meta(np.full(rows, m), np.full(rows, lat))
    im_b[:, 4] = nval_b = np.full(rows, w1b * m)
    n_pad = rows * w1b
    bmeta = np.stack([np.zeros(rows, int), np.arange(rows) * w1b,
                      np.zeros(rows, int), nval_b], 1).astype(np.int32)

    def put(a):
        return torch.as_tensor(a, device=dev)

    plans = {0: (ks, im_p, pmeta, ic.sweep_tiles(im_p, 0)),
             1: (ks, im_b, bmeta, ic.sweep_tiles(im_b, 1, xt_np, yt_np, n2f))}
    size = {0: P, 1: m * n_pad}
    for mode, name in ((0, "K2_pool"), (1, "K2_B")):
        dst_k = torch.zeros(size[mode], dtype=torch.float64, device=dev)
        dst_p = torch.zeros_like(dst_k)
        args = (combined, xt, yt, *(put(a) for a in plans[mode]), inv_scale, off_grid,
                mode, n_pad, n2f)
        ic.reset_l2_tiles()
        ic.sweep_d5512_scatter(dst_k, *args)
        l2 = ic.l2_tiles(dev)
        ic.sweep_d5512_scatter_plain(dst_p, *args)
        torch.cuda.synchronize()
        bound_ms, bound_by = k2_bound(mode, combined, xt, *plans[mode], n2f, inv_scale)
        out[name] = dict(
            shape=[rows, bucket, K, ns, ns], queries=int(plans[mode][1][:, 4].sum()),
            tiles=len(plans[mode][3]), l2_tiles=l2,
            max_abs_err=rel_err(torch, dst_k, dst_p),
            ms=median_ms(torch, lambda: ic.sweep_d5512_scatter(dst_k, *args), 20,
                         setup=dst_k.zero_),
            plain_ms=median_ms(torch, lambda: ic.sweep_d5512_scatter_plain(dst_p, *args), 5,
                               setup=dst_p.zero_),
            bound_ms=bound_ms, bound_by=bound_by)
    for name, rec in out.items():
        assert rec["max_abs_err"] < TOL, (name, rec)

    # the probe kernel at its entry point's shape; exact in f32; its
    # yardstick is the one PyTorch call x + 1.0, which is also its plain version
    from pyimcom_tpu_torch import probe

    xp = torch.as_tensor(rng.normal(size=(8, 128)), dtype=torch.float32, device=dev)
    got, want = probe.probe_add_one(xp), probe.probe_add_one_plain(xp)
    torch.cuda.synchronize()
    plain_ms = median_ms(torch, lambda: probe.probe_add_one_plain(xp), 20)
    bound_ms, bound_by = bound(8 * xp.numel(), xp.numel())
    out["probe"] = dict(shape=[8, 128], max_abs_err=float((got - want).abs().max()),
                        ms=median_ms(torch, lambda: probe.probe_add_one(xp), 20),
                        plain_ms=plain_ms, library_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by)
    assert out["probe"]["max_abs_err"] == 0.0, out["probe"]
    return out


def build_parent():
    """Build the earlier revision of the D5512 source, if present; returns
    the compiler's report.  Refuses any other revision than 60e58e7's: its
    K2 entry takes another argument list."""
    import hashlib

    from pyimcom_tpu_torch import _build

    digest = hashlib.sha256(PARENT_SRC.read_bytes()).hexdigest()
    if digest != PARENT_SHA256:
        raise RuntimeError(f"{PARENT_SRC} is not interp_d5512.cu of commit 60e58e7 "
                           f"(sha256 {digest}); parent_k2() binds only that revision")
    lib = PARENT_SRC.with_name("libinterp_d5512_parent.so")
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(PARENT_SRC)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {PARENT_SRC}:\n{proc.stderr}")
    return proc.stdout + proc.stderr


def parent_k2():
    """The K2 entry of commit 60e58e7 (rows in buckets, one thread a query,
    f64 atomics), loaded with ctypes; build_parent() checked the source."""
    import ctypes

    fn = ctypes.CDLL(str(PARENT_SRC.with_name("libinterp_d5512_parent.so"))).sweep_d5512_scatter
    p, i, ll, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
    fn.argtypes = (p, ll, p, i, i, i, p, p, ll, p, p, p, ll, i, d, d, i, i, i, p)
    fn.restype = ctypes.c_int
    return fn


class capture_first_plan:
    """While active, keep the first sweep plan that Block._plan_group makes
    (its rows, tiles, overlap stacks and coordinate tables) with the
    group's geometry, in `.plan`."""

    def __enter__(self):
        from pyimcom_tpu_torch import coadd, psfgrp

        self.plan, self._cls = None, coadd.Block
        self._orig = orig = coadd.Block._plan_group
        outer = self

        def plan_group(blk, infos, n_pad):
            plan = orig(blk, infos, n_pad)
            if outer.plan is None:
                outer.plan = dict(plan, n_pad=n_pad, S=len(infos), n2f=blk.cfg.n2f,
                                  n_out=blk.cfg.n_out, inv_scale=1.0 / blk.geom.dscale,
                                  off_grid=blk.geom.nc_ovl + psfgrp.INTERP_PAD)
            return plan

        coadd.Block._plan_group = plan_group
        return self

    def __exit__(self, *exc):
        # the overlap stacks wait in host memory, so that they add nothing
        # to the device memory of the phases that run before k2_main_path
        self._cls._plan_group = self._orig
        if self.plan is not None:
            self.plan["stacks"] = [s.cpu() for s in self.plan["stacks"]]


def k2_main_path(torch, dev, name, cap, parent):
    """Every K2 launch of one captured group, timed alone (median of 10 CUDA-
    event times after 2 warm-ups), against its plain version, with its bound
    and its L2-path tiles; and the earlier revision's launches (one per
    mode and query bucket, as its planner made them) on the same inputs."""
    from pyimcom_tpu_torch.ops import interp_cuda as ic
    from pyimcom_tpu_torch.psfgrp import _DENSE_BUCKETS

    combined = torch.cat([s.to(dev) for s in cap["stacks"]])
    xt = torch.as_tensor(cap["xt"], device=dev)
    yt = torch.as_tensor(cap["yt"], device=dev)
    n2f, n_pad, inv, off = cap["n2f"], cap["n_pad"], cap["inv_scale"], cap["off_grid"]
    m = n2f * n2f
    size = {0: cap["pool_size"], 1: cap["S"] * cap["n_out"] * m * n_pad}
    stream = torch.cuda.current_stream(dev).cuda_stream
    K, ny, nx = combined.shape

    def put(a):
        return torch.as_tensor(a, device=dev)

    rec = {"group": name, "stack": [K, ny, nx], "launches": []}
    for mode, ks, imeta, dmeta, tiles in cap["sweep_rows"]:
        args = (combined, xt, yt, put(ks), put(imeta), put(dmeta), put(tiles), inv, off,
                mode, n_pad, n2f)
        dst_k = torch.zeros(size[mode], dtype=torch.float64, device=dev)
        dst_p = torch.zeros_like(dst_k)
        ic.reset_l2_tiles()
        ic.sweep_d5512_scatter(dst_k, *args)
        l2 = ic.l2_tiles(dev)
        ic.sweep_d5512_scatter_plain(dst_p, *args)
        torch.cuda.synchronize()
        bound_ms, bound_by = k2_bound(mode, combined, xt, ks, imeta, dmeta, tiles, n2f, inv)
        one = dict(mode="pool" if mode == 0 else "B", rows=len(ks), tiles=len(tiles),
                   queries=int(imeta[:, 4].sum()), l2_tiles=l2,
                   max_abs_err=rel_err(torch, dst_k, dst_p),
                   ms=median_ms(torch, lambda: ic.sweep_d5512_scatter(dst_k, *args), 10,
                                setup=dst_k.zero_),
                   plain_ms=median_ms(torch, lambda: ic.sweep_d5512_scatter_plain(
                       dst_p, *args), 1, setup=dst_p.zero_),
                   bound_ms=bound_ms, bound_by=bound_by)
        assert one["max_abs_err"] < TOL, (name, one)
        if parent is not None:
            # the earlier planner's launches: this mode's rows by query bucket
            bidx = np.searchsorted(_DENSE_BUCKETS, imeta[:, 4])
            dst_q = torch.zeros_like(dst_k)
            calls = []
            for bi, bucket in enumerate(_DENSE_BUCKETS):
                sel = np.flatnonzero(bidx == bi)
                if not len(sel):
                    continue
                a = [put(np.ascontiguousarray(t[sel])) for t in (ks, imeta, dmeta)]

                def call(a=a, bucket=bucket):
                    err = parent(dst_q.data_ptr(), dst_q.numel(), combined.data_ptr(), K, ny,
                                 nx, xt.data_ptr(), yt.data_ptr(), xt.numel(), a[0].data_ptr(),
                                 a[1].data_ptr(), a[2].data_ptr(), a[0].numel(), bucket, inv,
                                 off, mode, n_pad, m, stream)
                    assert err == 0, err
                calls.append(call)
            dst_q.zero_()
            for call in calls:
                call()
            torch.cuda.synchronize()
            one["parent_max_abs_err"] = rel_err(torch, dst_q, dst_p)
            assert one["parent_max_abs_err"] < TOL, (name, one)
            one["parent_launches"] = len(calls)
            one["parent_ms"] = sum(median_ms(torch, call, 10, setup=dst_q.zero_)
                                   for call in calls)
        rec["launches"].append(one)
        del dst_k, dst_p
    for key in ("ms", "plain_ms", "bound_ms", "parent_ms"):
        if all(key in one for one in rec["launches"]):
            rec[key + "_sum"] = sum(one[key] for one in rec["launches"])
    return rec


def science(path):
    """Layer 0 of output PSF 0 of a block, in float64."""
    from pyimcom_tpu_torch.fitsio import fits_read

    return np.asarray(fits_read(path)[0].data[0, 0], dtype=np.float64)


def quality_check(path):
    """Star recovery SL1 and the U/C median of a bench block (the same
    decoding as bench.quality_check)."""
    from pyimcom_tpu_torch.fitsio import fits_read
    from pyimcom_tpu_torch.wcsutil import WCS

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

    from pyimcom_tpu_torch.coadd import Block
    from pyimcom_tpu_torch.config import Config
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
    from pyimcom_tpu_torch.fitsio import fits_read

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
    from survey_fixture_torch import SIG_OUT

    from pyimcom_tpu_torch.fitsio import fits_read
    from pyimcom_tpu_torch.layer_host import _shear_matrix
    from pyimcom_tpu_torch.utils.moments import find_adaptive_moments
    from pyimcom_tpu_torch.wcsutil import WCS, local_partial_pixel_derivatives2

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
    from concurrent.futures import ThreadPoolExecutor

    from pyimcom_tpu_torch import _build

    t0 = time.perf_counter()
    jobs = {"interp_d5512": lambda: _build.build("interp_d5512")}
    if PARENT_SRC.exists():
        jobs["interp_d5512_parent"] = build_parent
    with ThreadPoolExecutor(len(jobs)) as pool:
        reports = {k: f.result() for k, f in
                   {k: pool.submit(job) for k, job in jobs.items()}.items()}
    _build.library("interp_d5512")
    parent = parent_k2() if PARENT_SRC.exists() else None
    emit({"phase": "build", "gpu": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": time.perf_counter() - t0,
          "ptxas": {k: [ln.strip() for ln in r.splitlines()
                        if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
                    for k, r in reports.items()}})

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
    with capture_first_plan() as bench_cap:
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
    with capture_first_plan() as prod_cap:
        run_production(torch, dev, cfg_dict, "production_group", "_prod")
    run_production(torch, dev, cfg_dict, "production_iterative", "_prodit",
                   LAKERNEL="Iterative", KAPPAC=[0.0], ITERRTOL=0.0015, ITERMAX=30)
    run_production(torch, dev, cfg_dict, "production_eigen", "_prodeig",
                   LAKERNEL="Eigen", KAPPAC=MULTI_KAPPA)

    # ---- 8. K2 at the main path's own shapes ----------------------------------
    main_k2 = [k2_main_path(torch, dev, "bench_group_1", bench_cap.plan, parent),
               k2_main_path(torch, dev, "production_group", prod_cap.plan, parent)]
    del bench_cap.plan, prod_cap.plan
    for rec in main_k2:
        emit({"phase": "k2_main_path", "criterion": TOL, **rec})

    # ---- 9. galaxy injection: gsext14 at STOP 4, cold then warm ----------------
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
    no_lib = None           # no PyTorch call computes D5512 interpolation
    k2 = {one["mode"]: one for one in main_k2[0]["launches"]}
    summary = [
        {"name": "interp_d5512_dense", "route": "cuda", "source": src,
         "replaces": "pyimcom_tpu/ops/interp_pallas.py:85",
         "launches": launches["interp_d5512_dense"],
         "max_abs_err": kern["K1"]["max_abs_err"], "ms": kern["K1"]["ms"],
         "plain_ms": kern["K1"]["plain_ms"], "bound_ms": kern["K1"]["bound_ms"],
         "bound_by": kern["K1"]["bound_by"], "library_ms": no_lib}]
    for mode, key in (("pool", "K2_pool"), ("B", "K2_B")):
        errs = [kern[key]["max_abs_err"]] + [one["max_abs_err"] for rec in main_k2
                                              for one in rec["launches"] if one["mode"] == mode]
        summary.append(
            {"name": f"sweep_d5512_scatter.{mode}", "route": "cuda", "source": src,
             "replaces": "pyimcom_tpu/ops/interp_pallas.py:140",
             "launches": launches[f"sweep_d5512_scatter.{mode}"], "max_abs_err": max(errs),
             "ms": k2[mode]["ms"], "plain_ms": k2[mode]["plain_ms"],
             "bound_ms": k2[mode]["bound_ms"], "bound_by": k2[mode]["bound_by"],
             "library_ms": no_lib})
    summary.append(
        {"name": "probe_add_one", "route": "cuda", "source": "pyimcom_tpu_torch/csrc/probe.cu",
         "replaces": "scripts/probe_pallas.py:33", "launches": probe_launches,
         "max_abs_err": kern["probe"]["max_abs_err"], "ms": kern["probe"]["ms"],
         "plain_ms": kern["probe"]["plain_ms"], "bound_ms": kern["probe"]["bound_ms"],
         "bound_by": kern["probe"]["bound_by"], "library_ms": kern["probe"]["library_ms"]})
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
