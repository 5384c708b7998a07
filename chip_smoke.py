#!/usr/bin/env python3
"""
Smoke run of pyimcom_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA GPU

It builds the port's CUDA kernels from csrc/ and drives the port's paths
through the user's entry points: the block coadd
``pyimcom_tpu_torch.coadd.Block(cfg, this_sub, device="cuda")`` with every
LAKERNEL and both interpolation families, the split-PSF entries
``pyimcom_tpu_torch.splitpsf.{splitpsf,imsubtract,update_cube}``, the
destriping entry point ``pyimcom_tpu_torch.imdestripe.main``,
the toolchain probe ``pyimcom_tpu_torch.probe``, the bench entry
``pyimcom_tpu_torch.bench``, the block runner ``pyimcom_tpu_torch.runner``,
the chained pipeline ``pyimcom_tpu_torch.pipeline``, the Piff conversion
``pyimcom_tpu_torch.utils.piffutils.piff_to_legendre_multi`` and
metadetection ``pyimcom_tpu_torch.meta.distortimage.MetaMosaic``:

1. build: the card's name and power limit, the nvcc builds of the D5512 /
   G4460 and bilinear kernels (and of the earlier revisions in PARENTS, each
   where pyimcom_tpu_torch/_build/parent/ holds its source, pinned by its
   SHA-256: interp_d5512.cu of commit 7671040, the one-thread-a-query K1
   with a 9-argument C entry, and bilinear.cu of commit c560e0f, the
   one-thread-a-query K4 with a 9-argument C entry), started together, with
   their ptxas register and spill lines and the atomic instructions in K4's
   SASS (cuobjdump);
2. probe: the probe entry point builds csrc/probe.cu and launches its
   kernel on an (8, 128) float32 tensor (its own path: counts reset before,
   read after);
3. kernels: the card's launch floor (the device time of an empty kernel,
   torch.cuda._sleep(0)); each kernel against its plain PyTorch version on
   the card, on seeded random inputs at its path's shapes (criterion: 1e-12
   of scale in f64, exact for the probe), with the device times of both
   and the kernel's bounds; the sleep check of the timing on K1 and the
   probe (below);
4. bench_block: BASELINE.json configs[0] (8 exposures, cstar14, all 16
   stamps of block 1) -- a cold run that builds the input layers, then the
   measured warm run: blocks/hour, phase times, SL1, the U/C median, and the
   kernel launch counts of both runs; then bench_line: the bench entry's
   warm bench block (bench.bench_block) and its line as
   ``python -m pyimcom_tpu_torch.bench`` prints it (|SL1-1| < 5e-4, U/C <
   1e-6); then checkpoint: the bench block with a snapshot after every group
   (checkpoint_sec=0) in a child process that ends itself with os._exit
   after its 2nd snapshot, resumed in a fresh process: the groups it
   skipped, its seconds, the science within 1e-12 of scale of the
   uninterrupted warm block and the maps within 1 LSB, the snapshot removed;
5. eigen_block: configs[1], LAKERNEL Eigen at KAPPAC [5e-4, 1e-3, 2e-3],
   all 16 stamps, warm: blocks/hour, phase times, SL1 (|SL1-1| < 1e-3), the
   U/C median and the launch counts;
6. solver_cross: STOP 2 with single- and multi-kappa Cholesky, Eigen,
   Iterative and Empirical, compared in the star stamp [0:25, 25:50] at the
   bounds of tests/test_e2e_kernels.py, with each solver's solve-phase time;
   and both without quality control (EMPIRNQC): Iterative within 1e-12 of
   scale of Iterative, Empirical of Empirical where its science is finite,
   Empirical launching no K1 or K2; then runner: ``python -m
   pyimcom_tpu_torch.runner cfg.json --block 1`` in a process of its own,
   held to the warm bench block (1e-12 of scale, maps 1 LSB), the same
   command again, which must skip the finished block, and ``--all --workers
   2`` at STOP 2 (a forkserver pool of two processes on the card): all four
   blocks written, block 1 held to the in-process STOP-2 Cholesky block;
7. production_group / production_iterative / production_eigen: one 2x2
   group at production geometry (OUTSIZE [80, 32, 0.0390625], INPAD 1.055,
   NPIXPSF 48) with Cholesky, with the production default solve of
   configs/default_config.json (Iterative, KAPPAC [0.0], ITERRTOL 0.0015,
   ITERMAX 30) and with Eigen: seconds per stamp, n per stamp, peak device
   memory, U/C and Sigma medians; every output map must be finite; beside
   the Cholesky group, production_mixed: the same group at SOLVERPREC
   "mixed" (a float32 factorization with float64 refinement), its U/C and
   Sigma medians within 1e-6 and 1e-4 of the Cholesky group's
   (tests/test_solvers.py::test_mixed_precision_matches_f64's bounds), and
   both solves alone at n 5120 (solve_alone); then
   pool_budget: STOP 164 (a row of 40 groups and the first group of the
   second) with Cholesky, first with the default pool budget, then with a
   third of that run's retained peak: the retained pool bytes after each
   group, peak and reserved device memory, seconds a stamp, evictions,
   recomputed submatrices and the extra K2 launches, the second run within
   1e-12 of scale of the first;
8. k2_main_path: K2 on the sweep rows, overlap stack and coordinate tables
   of the first group of the warm bench block and of the Cholesky
   production group (captured while those blocks ran): every launch of each
   group timed alone and summed, against its plain version (1e-12 of
   scale), with its bounds and the tiles it took from L2;
9. galaxy_block: a gsext14 galaxy layer (n=0.5, hlr=0.1, shape=0.2:0.1) at
   STOP 4, cold: adaptive moments against the analytic covariance (5e-4
   arcsec^2), the flux (0.97-1.03), the cold input time and the K1 launches
   of the injection (cold minus warm run; above 0);
10. k1_main_path: K1 on the first launch of each of its callers, captured
   while the blocks ran -- star injection in the cold bench block, PSF
   sampling in the warm bench block and the Cholesky production group,
   galaxy injection in the galaxy block: R, Nq, the image shape and the
   queries on the grid, its device time against its plain version (1e-12 of
   scale) and the earlier revision's K1 (held to the same) where built, its
   bounds and share of the bound, and, for PSF sampling, its time with runs
   of 32 consecutive queries instead of 8 x 4 lattice points;
11. g4460_block: the bench block with PSFINTERP "G4460", warm: blocks/hour,
   phase times, SL1 and the U/C median, equal to the port's CPU record of
   the same block (CPU_RECORD_G4460) to 1e-8 relative; psfsplit_loop (in
   .smoke_work/psfsplit/): BASELINE.json config 3 as one run on
   tests/test_psfsplit_e2e.py's survey (n_obs 8, NPIXPSF 16, INPAD 0.4; the
   science layer only: injecting its cstar14 grid with the 768^2 Legendre
   stamps costs ~50 s of host time an exposure; the whole block 1) through
   the port's entries -- each
   observation's PSF written as a Piff file (as piff_block below writes
   them, at the cube's own sampling), piff_to_legendre_multi on the card
   for the chip each observation places on the field (C3_LEGENDRE: stamp
   128 and oversampling 6, the JAX defaults, at Legendre order 1), with
   the first observation's conversion on the CPU route beside it;
   splitpsf.main as a job array (one process an observation, INPSF
   [legendre dir, "L2_2506", 6], PSFSPLIT [3.0, 6.0, 0.01, true]); the
   iteration-0 block; the wing subtraction as one job-array task
   (``imsubtract cfg <sca>`` for the SCA with the fewest cached exposures,
   at least one; 4088^2) at the split files' oversampling
   with bin2x2, given none; update_cube; the iteration-1 block: seconds per
   stage; the conversion's seconds and bytes, the split tasks' seconds and
   the split files' bytes; per exposure the canvas side, the host geometry
   seconds, the K1<8> launches and device ms, the FFT device ms, peak
   device memory and the host resident set; the criteria: the card's
   Legendre cubes within 2 float32 spacings of max|cube[0]| of the CPU
   route's and equal headers, OVSAMP 6 in the Legendre and split files,
   every split HDU finite (placeholders too), count >= 4, GSSKIP, KERSKIP,
   IMSBITER 0 then 1, the history's iteration 0, the canvas of the split
   files' binned kernels, max|delta| > 0, median|delta| < 0.5 max|a|, and
   in both iterations finite maps, a U/C median < 1e-6 and the science
   star's SL1 within 5e-3 (tests/test_full_pipeline.py:165's bound) of
   survey_fixture_torch.pixel_twice_sl1 -- the Legendre cubes converted
   from Piff files hold the pixel response, which the split applies again,
   a fault both packages share (ROADMAP.md queue 3) -- and iteration 1's
   VAR below max(1.05 x iteration 0's, 1e-5) (:166); the iteration-0
   block's first K1 launch of PSF sampling (as k1_main_path) and its first
   group's K2 launches (as k2_main_path) against their plain versions;
   fftconv_full: one fftconvolve_multi at the unbinned production canvas
   (FFT_SIDE^2, a 120^2 kernel, seeded random data on the card): device
   ms, peak memory, a 2048^2 crop against the CPU route (1e-12 of scale),
   and the bytes and operations bounds of one convolution at that side and
   at the loop's (fft_bounds); g4460_kernels: K1<8> alone on its captured
   launches (PSF sampling of the G4460 block, the first wing canvas of the
   loop's task, at most 2^22 queries of it) and K2<8> (pool, B) on the
   G4460 block's first group, against their plain versions (1e-12 of
   scale), with their bounds;
11b. piff_block (in .smoke_work/piff/): the bench survey with each
   observation's PSF written as a Piff file as tests/test_piff.py:115-127
   writes them (survey_fixture_torch.write_piff_files: per SCA the cube's
   plane 0 smeared by the pixel tophat, at the cube's own sampling of
   1/INPSF[2] native pixel, order 1 with seeded u and v terms of at most
   1e-3 of the peak) and INPSF [dir, "piff", 8]: block 1, all 16 stamps,
   a first run, then the measured warm run: seconds, blocks/hour, SL1 and
   the U/C median (|SL1-1| < 5e-4, U/C < 1e-6) and their difference from
   the bench block's, block.inputs and psf.sample_group host seconds, the
   Piff draws (utils.piffutils.draw_models, one a PSF group): calls, their
   host seconds and device time in the block (the block's psf.draw phase)
   and alone (the group's interpolation behind the sleep), one group's
   batched draw against its S single draws (host seconds), and the card's
   draw of that group against the CPU route's (1 float32 spacing of
   max|stamp|); K1 and K2 launched; the warm run's first K1 launch of PSF
   sampling (as k1_main_path) and its first group's K2 launches (as
   k2_main_path) against their plain versions (1e-12 of scale);
12. destripe (in .smoke_work/destripe/): build_survey(n_obs=6) less its
   fourth F184 exposure -- 3 F184 SCAs at 4088^2 overlapping in 6 ordered
   pairs (the host builds ~10 s of pair map a pair) -- with row stripes
   injected as scripts/run_chained_pipeline.py does, then
   ``pyimcom_tpu_torch.imdestripe.main(cfg, maxiter=5)`` on the card (object
   mask and WCS gain on): the host map build and upload seconds, peak device
   memory, seconds per CG iteration, the cost before and after, the K3 / K4
   launches, the K4 tiles that took the global route, one cost-and-gradient's
   device time and its kernels by name from one torch.profiler trace; the
   kernel route of the
   cost against its plain route (autograd through the plain gather) at zero
   and random parameters (cost to rtol 1e-12, gradient to rtol 1e-9 and atol
   1e-12); at least half of the SCAs destriped by 2x in their row medians
   against the clean files (tests/test_full_pipeline.py); then K3 and K4
   alone on the first pair (against their plain versions, their bounds,
   grid_sample and its input gradient as the library yardstick, and the
   earlier revision's K4 where built; K4's tile, shared memory, registers
   and its global-route tiles against predict_global_tiles); and the
   bench block coadded from the clean, striped and destriped inputs (each
   with its own input directory and layer cache): 16 stamps, finite maps,
   U/C medians equal to 1e-6, the destriped science nearer the clean one
   than the striped, by RMS, and the SL1 of all three;
13. mosaic_chain (in .smoke_work/mosaic_chain/): ``pyimcom_tpu_torch.pipeline``
   as scripts/run_chained_pipeline.py's defaults run it, except --n-obs 6
   (4 F184 SCAs, 12 ordered pairs): a 2x2 mosaic of 8 x 8 stamps of 32
   px at 0.0390625", NPIXPSF 48, INPAD 1.055, PAD 1 on every side, cstar14
   and whitenoise1, through destripe (5 CG iterations), the layer caches
   (a forkserver pool), the four blocks, the halo exchange and compression:
   the seconds of every stage and the launches of K1-K4 in each (K3 and K4
   in destripe, K1 in layers, K1 and K2 in the coadd; the layer builds'
   K1 launches are counted in the pool's workers); at least half of the
   SCAs destriped by 2x in their row medians; every output map finite; the
   U/C median of every block < 1e-6; |SL1 - 1| < 5e-3 of the science star
   on block _00_01 (tests/test_full_pipeline.py's bound); every compressed
   layer read back through compress.ReadFile within the I24B step plus
   float32 noise (pipeline.compression_check) and every other HDU equal;
   without the report stage (``report=False``: the card's machine has no
   matplotlib, which the report draws with);
13b. meta_shear: meta.MetaMosaic on block _00_01 of the chain's mosaic (its
   3x3 neighbourhood: 4 blocks of 256^2), examples/read_and_shear.py's
   steps -- mask_fidelity_cut(40), shearimage(N = n1 n2, the reduced shear
   (0.02, 0), psfgrow 1.08), then its mask_noise_cut(-3) (which masks
   every pixel: the noise map holds Sigma, not dB) and the same shear --
   on the card and on the CPU route, the images within 2 float32 spacings
   of the maximum and the masks equal, with seconds, UMAX, SMAX and the
   masked share of each; then MultiInterp at production
   size: a seeded 3x3 mosaic of 2560^2 blocks (7680^2, 2 float32 layers),
   153 rows of a 2560-wide output at its centre (META_ROWS: 1 of the 17
   blocks of 393216 points of the whole 2560^2 output) under the same
   shear and smoothing: InterpMatrix's
   host seconds, the tap gather's device time (CUDA events around each
   block's gather_taps) and kernel launches (torch.profiler), the seconds,
   peak device memory and the host resident set.

Timing.  A kernel's time is the median CUDA-event time of single calls,
each enqueued behind a torch.cuda._sleep of SLEEP_CYCLES, so that the
events bracket the device's work and not the host's enqueue; the sleep
check prints the median behind twice the sleep, which must fall inside the
first run's spread.  A bound is the least time the card could take for a
kernel's work: the larger of the bytes it must move (each input read once,
each output written once) over 3.35 TB/s and its f64 operations over 67
TFLOP/s (the H100 SXM data sheet; the f64 rate is that of the tensor cores,
twice the vector units') -- `roofline_ms`, the kernel line's bound -- and,
in `bound_ms`, the launch floor besides: a kernel whose bound is the floor
is at its bound.

``python3 chip_smoke.py --legendre-order N`` runs only legendre_cost: what
config 3's conversion and split cost at Legendre order N (the conversion
of one observation on the card, its file's bytes, one SCA's split on the
host, a split file's bytes), for the choice of C3_LEGENDRE's order.

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
CHAIN_SL1_TOL = 5e-3            # tests/test_full_pipeline.py, the chained star
CPU_RECORD = {"SL1": 0.999938, "uc_median": 3.65e-7}   # .bench_cpu_baseline.json
MULTI_KAPPA = [5e-4, 1e-3, 2e-3]                        # BASELINE.json configs[1]
STAR_REGION = np.s_[0:25, 25:50]                        # the stamp with the star
PROD = dict(OUTSIZE=[80, 32, 0.0390625], INPAD=1.055, NPIXPSF=48, STOP=4)
# production: a row of 40 groups and the first group of the second.  The
# sim pass counts the references of the stamps a run will coadd, so a row's
# pools are retained only when the run goes on to the next row's
POOL_ROW = PROD["OUTSIZE"][0] // 2
POOL_STOP = 4 * (POOL_ROW + 1)
GALAXY = "gsext14,n=0.5,hlr=0.1,shape=0.2:0.1"          # tests/test_e2e_galaxy.py
# the G4460 bench block on the CPU: python -m pyimcom_tpu_torch.bench --device cpu
# --full --psfinterp G4460
CPU_RECORD_G4460 = {"SL1": 0.9999383490946347, "uc_median": 8.283235329759168e-07}
# config 3 as one run on tests/test_psfsplit_e2e.py's survey: its PSFs as
# Piff files, converted to Legendre cubes at piff_to_legendre_multi's JAX
# defaults for stamp and oversampling but Legendre order 1 (the survey
# cubes' 4 planes; order 5's 36 planes make a 4.6 GB split file an
# observation and ~9 minutes of host splitting one: PERF.md section 4), the
# split files' OVSAMP 6 taken by the wing subtraction with bin2x2
PSFSPLIT_OVERRIDES = {"NPIXPSF": 16, "INPAD": 0.4}
PSFSPLIT = [3.0, 6.0, 0.01, True]
C3_LEGENDRE = dict(stamp_size=128, oversamp=6, legendre_order=1)
# the unbinned wing canvas of a 4088^2 SCA: oversampling 6, I_pad 10 (the
# survey cubes' 120^2 kernels)
FFT_SIDE = 6 * (4088 + 2 * 10)
# the Piff block draws at oversampling 8 (INPSF [dir, "piff", 8]) from files
# at the cube's own sampling, with seeded order-1 terms of at most 1e-3 of
# the peak (survey_fixture_torch.write_piff_files)
PIFF_OV, PIFF_GRAD, PIFF_SEED = 8, 1e-3, 20261017
# examples/read_and_shear.py: the reduced shear (g1, g2) and psfgrow; the
# MultiInterp run at production size: output rows of a block's side
# (OUTSIZE 80 stamps of 32 px) over a 3x3 mosaic of such blocks, 153 of the
# 2560 rows (1 of MultiInterp's 17 blocks of 393216 points: InterpMatrix
# costs ~30 us a point of host time, 12 s a block on the card's host)
META_SHEAR, META_PSFGROW, META_PROD, META_ROWS = (0.02, 0.0), 1.08, 2560, 153
PARENT_DIR = REPO / "pyimcom_tpu_torch" / "_build" / "parent"
# earlier revisions of csrc/<name>.cu timed beside the current kernels where
# PARENT_DIR holds them: the commit and the SHA-256 of the only revision
# whose entry parent_entry() binds
PARENTS = {
    "interp_d5512": ("7671040", "8aaf4ea17e3cd5b6b57ddceda891cd142db8ba5ba2f67bf43b7736a0bec0eeef",
                     "interp_d5512_dense"),
    "bilinear": ("c560e0f", "aa9d46b1a6683c0509634b51bdac866b6d80cef0b8af2a27853d0ed8f6323330",
                 "bilinear_scatter_adjoint"),
}
PEAK_BYTES_S, PEAK_F64_S = 3.35e12, 67e12               # H100 SXM data sheet
# one tap set of each family (Horner in fh^2: 19 operations a pair of taps,
# and fh^2), and one query: two tap sets, the k x k sum (k^2 + k
# multiply-adds) and the position
TAPS = {"D5512": 10, "G4460": 8}
TAPS_FLOP = {k: 19 * t // 2 + 1 for k, t in TAPS.items()}
QUERY_FLOP = {k: 2 * TAPS_FLOP[k] + 2 * (t * t + t) + 6 for k, t in TAPS.items()}
# one in-bounds query of K3 (floors, weights, gain weights, norm, the sum,
# the division, the accumulator) and of K4 (the same taps, norm and division,
# four products and four adds)
GATHER_FLOP, ADJOINT_FLOP = 27, 27
# torch.cuda._sleep cycles enqueued before a timed call, so that the device
# is still busy while the host enqueues it (about 0.2 ms at 1.98 GHz)
SLEEP_CYCLES = 400_000


T_START = time.perf_counter()


def emit(obj):
    """Print one JSON line; a phase's line carries the seconds since the
    script started (`elapsed_s`)."""
    if "phase" in obj:
        obj = dict(obj, elapsed_s=time.perf_counter() - T_START)
    print(json.dumps(obj), flush=True)


def gpu_name_and_power():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def device_times(torch, fn, reps, setup=None, sleep=SLEEP_CYCLES):
    """CUDA-event times (ms) of fn() over `reps` calls, after 2 warm-ups.
    Each call is enqueued behind a `sleep`-cycle device sleep, recorded
    after it, so that the events bracket device work and not the host's
    enqueue of fn (its argument checks, ctypes call and launch).  A
    function that enqueues for longer than the sleep (a plain version's
    many small launches) still shows its host time."""
    times = []
    for i in range(reps + 2):
        if setup is not None:
            setup()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        if i >= 2:
            times.append(e0.elapsed_time(e1))
    return times


def median_ms(torch, fn, reps, setup=None):
    """Median device time of fn() over `reps` calls (device_times)."""
    return statistics.median(device_times(torch, fn, reps, setup))


def sleep_check(torch, fn, reps=20):
    """The device time of fn() behind the sleep and behind twice the sleep:
    if the sleep outlasts the host's enqueue, doubling it leaves the median
    inside the first run's spread."""
    t1 = device_times(torch, fn, reps)
    t2 = device_times(torch, fn, reps, sleep=2 * SLEEP_CYCLES)
    rec = dict(ms=statistics.median(t1), spread=[min(t1), max(t1)],
               ms_double_sleep=statistics.median(t2), spread_double_sleep=[min(t2), max(t2)])
    assert min(t1) <= rec["ms_double_sleep"] <= max(t1), rec
    return rec


def rel_err(torch, got, want):
    scale = float(want.abs().max())
    assert scale > 0, "reference output is all zero"
    return float((got - want).abs().max()) / scale


def bound(bytes_, flops, floor_ms=0.0):
    """(bound ms, what sets it) of a kernel moving `bytes_` and doing `flops`,
    launched on a card whose empty kernel takes `floor_ms`."""
    t_b, t_f = bytes_ / PEAK_BYTES_S * 1e3, flops / PEAK_F64_S * 1e3
    return max((t_b, "bytes"), (t_f, "operations"), (floor_ms, "launch"))


def bounds(bytes_, flops, floor_ms):
    """A kernel record's bounds: `bound_ms` with the launch floor (what a
    launch can reach), `roofline_ms` without it (bytes and operations
    alone, the `kernels` line's bound)."""
    b, by = bound(bytes_, flops, floor_ms)
    rb, rby = bound(bytes_, flops)
    return dict(bound_ms=b, bound_by=by, roofline_ms=rb, roofline_by=rby)


def k2_bound(mode, combined, xt, ks, imeta, dmeta, tiles, n2f, inv_scale, floor_ms,
             kern="D5512"):
    """Bounds (bounds()) of one K2 launch of family `kern`: the overlap
    images its rows use, the tables, the metadata, and each destination read
    and written once; in pool mode QUERY_FLOP a query, in B mode the
    separable form's tap sets and horizontal and vertical sums."""
    from pyimcom_tpu_torch.ops.interp_cuda import b_window

    queries = int(imeta[:, 4].sum())
    images = len(np.unique(ks[imeta[:, 4] > 0]))
    ny, nx = combined.shape[1:]
    bytes_ = (8 * images * ny * nx + 16 * xt.shape[0] + 16 * queries
              + 4 * (ks.size + imeta.size + dmeta.size + tiles.size))
    if mode == 0:
        flops = QUERY_FLOP[kern] * queries
    else:
        m = n2f * n2f
        per_sum = 2 * TAPS[kern]
        per_i1 = (2 * n2f * TAPS_FLOP[kern] + b_window(n2f, inv_scale, kern) * n2f * per_sum
                  + m * per_sum)
        flops = per_i1 * queries / m
    return bounds(bytes_, flops, floor_ms)


def k1_record(torch, dev, images, x, y, floor_ms, parent, lattice_row=0, reps=20,
              kern="D5512"):
    """K1 of family `kern` on one launch's inputs (on the card; `lattice_row`
    as its caller passed it): its device time, its runs of 32 queries, its
    error against the plain version, the plain version's time,
    the bounds (images, x, y and the result once; QUERY_FLOP a query on the
    grid), and the earlier revision's K1 (D5512) on the same inputs where
    built."""
    from pyimcom_tpu_torch.ops import interp_cuda as ic
    from pyimcom_tpu_torch.ops.interp import KERNEL_FAMILIES

    lo, hi = KERNEL_FAMILIES[kern][3:]
    R, ny, nx = images.shape
    Nq = x.shape[1]
    fx, fy = torch.floor(x), torch.floor(y)
    on = int(((fx >= lo) & (fx < nx - hi) & (fy >= lo) & (fy < ny - hi)).sum())
    got = ic.interp_dense(images, x, y, kern, lattice_row=lattice_row)
    want = ic.interp_dense_plain(images, x, y, kern)
    torch.cuda.synchronize()
    runs = (R * -(-lattice_row // 8) * -(-(Nq // lattice_row) // 4) if lattice_row
            else R * -(-Nq // 32))
    rec = dict(kern=kern, R=R, Nq=Nq, image=[ny, nx], lattice_row=lattice_row, on_grid=on,
               runs=runs, max_abs_err=rel_err(torch, got, want),
               ms=median_ms(torch, lambda: ic.interp_dense(
                   images, x, y, kern, lattice_row=lattice_row), reps),
               plain_ms=median_ms(torch, lambda: ic.interp_dense_plain(images, x, y, kern), 3),
               **bounds(8 * (images.numel() + 3 * x.numel()), QUERY_FLOP[kern] * on, floor_ms),
               launch_floor_ms=floor_ms)
    rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    assert rec["max_abs_err"] < TOL, rec
    if parent is not None and kern == "D5512":
        out_p = torch.empty_like(x)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def call():
            err = parent(images.data_ptr(), R, ny, nx, x.data_ptr(), y.data_ptr(), Nq,
                         out_p.data_ptr(), stream)
            assert err == 0, err
        call()
        torch.cuda.synchronize()
        rec["parent_max_abs_err"] = rel_err(torch, out_p, want)
        assert rec["parent_max_abs_err"] < TOL, rec
        rec["parent_ms"] = median_ms(torch, call, reps)
    return rec


def phase_kernels(torch, dev, parent):
    """The launch floor and the sleep check of the timing; K1 and K2 against
    their plain versions on seeded random inputs at main-path shapes (none
    of the main path's locality: K2's pool tiles read from L2;
    k1_main_path and k2_main_path time the main path's own launches); and
    the probe kernel."""
    from pyimcom_tpu_torch.ops import interp_cuda as ic
    from pyimcom_tpu_torch.psfgrp import _DENSE_RBATCH_BY_BUCKET

    rng = np.random.default_rng(20261016)
    ns = 263                              # bench overlap image: novl + 12
    # the card's launch floor: an empty kernel's device time
    floor_ms = median_ms(torch, lambda: torch.cuda._sleep(0), 50)
    out = {"launch_floor_ms": floor_ms}

    # K1: R x Nq = 32 x 16384 (a chunk of star patches, 128^2 each), random
    R, Nq = 32, 16384
    images = torch.as_tensor(rng.normal(size=(R, ns, ns)), device=dev)
    x = torch.as_tensor(rng.uniform(0, ns, (R, Nq)), device=dev)
    y = torch.as_tensor(rng.uniform(0, ns, (R, Nq)), device=dev)
    out["K1"] = dict(shape=[R, Nq, ns, ns],
                     **k1_record(torch, dev, images, x, y, floor_ms, parent))
    out["K1"]["sleep_check"] = sleep_check(torch, lambda: ic.interp_dense(images, x, y))
    del images, x, y

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
        ic.sweep_scatter(dst_k, *args)
        l2 = ic.l2_tiles(dev)
        ic.sweep_scatter_plain(dst_p, *args)
        torch.cuda.synchronize()
        out[name] = dict(
            shape=[rows, bucket, K, ns, ns], queries=int(plans[mode][1][:, 4].sum()),
            tiles=len(plans[mode][3]), l2_tiles=l2,
            max_abs_err=rel_err(torch, dst_k, dst_p),
            ms=median_ms(torch, lambda: ic.sweep_scatter(dst_k, *args), 20,
                         setup=dst_k.zero_),
            plain_ms=median_ms(torch, lambda: ic.sweep_scatter_plain(dst_p, *args), 5,
                               setup=dst_p.zero_),
            **k2_bound(mode, combined, xt, *plans[mode], n2f, inv_scale, floor_ms))
    for name, rec in out.items():
        if name != "launch_floor_ms":
            assert rec["max_abs_err"] < TOL, (name, rec)

    # the probe kernel at its entry point's shape; exact in f32; its
    # yardstick is the one PyTorch call x + 1.0, which is also its plain version
    from pyimcom_tpu_torch import probe

    xp = torch.as_tensor(rng.normal(size=(8, 128)), dtype=torch.float32, device=dev)
    got, want = probe.probe_add_one(xp), probe.probe_add_one_plain(xp)
    torch.cuda.synchronize()
    plain_ms = median_ms(torch, lambda: probe.probe_add_one_plain(xp), 20)
    out["probe"] = dict(shape=[8, 128], max_abs_err=float((got - want).abs().max()),
                        ms=median_ms(torch, lambda: probe.probe_add_one(xp), 20),
                        plain_ms=plain_ms, library_ms=plain_ms,
                        **bounds(8 * xp.numel(), xp.numel(), floor_ms),
                        sleep_check=sleep_check(torch, lambda: probe.probe_add_one(xp)))
    assert out["probe"]["max_abs_err"] == 0.0, out["probe"]
    return out


def parent_src(name):
    return PARENT_DIR / f"{name}.cu"


def build_parent(name):
    """Build the earlier revision of csrc/<name>.cu in PARENT_DIR; returns
    the compiler's report.  Refuses any other revision than PARENTS names:
    its entry takes another argument list."""
    import hashlib

    from pyimcom_tpu_torch import _build

    commit, sha, _entry = PARENTS[name]
    src = parent_src(name)
    digest = hashlib.sha256(src.read_bytes()).hexdigest()
    if digest != sha:
        raise RuntimeError(f"{src} is not {name}.cu of commit {commit} (sha256 {digest}); "
                           f"parent_entry() binds only that revision")
    lib = src.with_name(f"lib{name}_parent.so")
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    return proc.stdout + proc.stderr


def parent_entry(name):
    """The earlier revision's entry, loaded with ctypes (build_parent()
    checked the source), or None where PARENT_DIR does not hold it: K1 of
    commit 7671040 (one thread a query, each patch read from L1 / L2) and K4
    of commit c560e0f (one thread a query, four f64 atomicAdds into device
    memory), both with 9 arguments."""
    import ctypes

    if not parent_src(name).exists():
        return None
    fn = getattr(ctypes.CDLL(str(parent_src(name).with_name(f"lib{name}_parent.so"))),
                 PARENTS[name][2])
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = {"interp_d5512": (p, i, i, i, p, p, ll, p, p),
                   "bilinear": (p, p, i, i, p, p, ll, p, p)}[name]
    fn.restype = ctypes.c_int
    return fn


def ptxas_entries(report):
    """{entry: {registers, spill_stores, spill_loads}} from nvcc's -Xptxas -v
    report."""
    import re

    out, entry = {}, None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            entry = m.group(1)
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out.setdefault(entry, {}).update(spill_stores=int(m.group(1)),
                                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.setdefault(entry, {})["registers"] = int(m.group(1))
    return out


def sass_atomics(lib, match):
    """{function: {opcode: count}} of the atomic and reduction instructions
    (ATOM*, RED*) in the SASS of the functions of `lib` whose name holds
    `match` (cuobjdump -sass)."""
    import re

    from pyimcom_tpu_torch import _build

    tool = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    out, func = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            func = ln.split("Function :")[1].strip()
            continue
        m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", ln)
        if func and match in func and m and m.group(1).startswith(("ATOM", "RED")):
            ops = out.setdefault(func, {})
            ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    return out


class capture_k1:
    """While active, keep the first K1 launch of each caller named in
    `callers` (its images, x and y, its family and its lattice row) in
    `into`, keyed "<block>/<caller>": a copy on the card, which does not
    wait for the card, moved to host memory when the block is done (at most
    `max_queries` queries an image).  A caller is the innermost frame among
    PSF sampling (psfgrp.sample_psf_rotated_batch), star injection
    (layer.make_image_from_grid), galaxy injection
    (layer.make_extobj_image_from_grid) and the wing canvas of split-PSF
    wing subtraction (splitpsf.imsubtract._interp_scattered)."""

    CALLERS = {"sample_psf_rotated_batch": "psf_sampling",
               "make_image_from_grid": "star_injection",
               "make_extobj_image_from_grid": "galaxy_injection",
               "_interp_scattered": "wing_canvas"}

    def __init__(self, block, callers, into, max_queries=None):
        self.block, self.callers, self.launches = block, set(callers), into
        self.max_queries = max_queries

    def __enter__(self):
        from pyimcom_tpu_torch.ops import interp_cuda

        self._mod, self._orig = interp_cuda, interp_cuda.interp_dense
        orig = self._orig

        def wrapped(images, x, y, kern="D5512", **kw):
            f = sys._getframe(1)
            while f is not None and f.f_code.co_name not in self.CALLERS:
                f = f.f_back
            caller = self.CALLERS[f.f_code.co_name] if f is not None else None
            key = f"{self.block}/{caller}"
            if caller in self.callers and key not in self.launches:
                n = x.shape[1] if self.max_queries is None else min(x.shape[1],
                                                                    self.max_queries)
                self.launches[key] = dict(images=images.clone(), x=x[:, :n].clone(),
                                          y=y[:, :n].clone(), kern=kern,
                                          lattice_row=kw.get("lattice_row", 0),
                                          queries_of_launch=x.shape[1])
            return orig(images, x, y, kern, **kw)

        interp_cuda.interp_dense = wrapped
        return self

    def __exit__(self, *exc):
        self._mod.interp_dense = self._orig
        for cap in self.launches.values():
            for k in ("images", "x", "y"):
                cap[k] = cap[k].cpu()


def k1_main_path(torch, dev, key, cap, floor_ms, parent):
    """K1 on one captured main-path launch (k1_record); where the caller
    gave a lattice row, also its time with runs of 32 consecutive queries
    (`runs_of_32_ms`), timed beside the 8 x 4 layout in this call."""
    from pyimcom_tpu_torch.ops import interp_cuda as ic

    block, caller = key.split("/")
    images, x, y = (cap[k].to(dev) for k in ("images", "x", "y"))
    n, kern = cap["lattice_row"], cap["kern"]
    rec = {"block": block, "caller": caller, "queries_of_launch": cap["queries_of_launch"],
           **k1_record(torch, dev, images, x, y, floor_ms, parent, lattice_row=n, kern=kern)}
    if n:
        rec["runs_of_32_ms"] = median_ms(torch, lambda: ic.interp_dense(images, x, y, kern), 20)
    return rec


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
                                  off_grid=blk.geom.nc_ovl + psfgrp.INTERP_PAD,
                                  kern=blk.geom.psfinterp)
            return plan

        coadd.Block._plan_group = plan_group
        return self

    def __exit__(self, *exc):
        # the overlap stacks wait in host memory, so that they add nothing
        # to the device memory of the phases that run before k2_main_path
        self._cls._plan_group = self._orig
        if self.plan is not None:
            self.plan["stacks"] = [s.cpu() for s in self.plan["stacks"]]


def k2_main_path(torch, dev, name, cap, floor_ms):
    """Every K2 launch of one captured group, timed alone (median device
    time of 10 calls after 2 warm-ups), against its plain version, with its
    bounds and its L2-path tiles."""
    from pyimcom_tpu_torch.ops import interp_cuda as ic

    combined = torch.cat([s.to(dev) for s in cap["stacks"]])
    xt = torch.as_tensor(cap["xt"], device=dev)
    yt = torch.as_tensor(cap["yt"], device=dev)
    n2f, n_pad, inv, off = cap["n2f"], cap["n_pad"], cap["inv_scale"], cap["off_grid"]
    kern = cap["kern"]
    m = n2f * n2f
    size = {0: cap["pool_size"], 1: cap["S"] * cap["n_out"] * m * n_pad}
    K, ny, nx = combined.shape

    def put(a):
        return torch.as_tensor(a, device=dev)

    rec = {"group": name, "kern": kern, "stack": [K, ny, nx], "launches": []}
    for mode, ks, imeta, dmeta, tiles in cap["sweep_rows"]:
        args = (combined, xt, yt, put(ks), put(imeta), put(dmeta), put(tiles), inv, off,
                mode, n_pad, n2f, kern)
        dst_k = torch.zeros(size[mode], dtype=torch.float64, device=dev)
        dst_p = torch.zeros_like(dst_k)
        ic.reset_l2_tiles()
        ic.sweep_scatter(dst_k, *args)
        l2 = ic.l2_tiles(dev)
        ic.sweep_scatter_plain(dst_p, *args)
        torch.cuda.synchronize()
        one = dict(mode="pool" if mode == 0 else "B", rows=len(ks), tiles=len(tiles),
                   queries=int(imeta[:, 4].sum()), l2_tiles=l2,
                   max_abs_err=rel_err(torch, dst_k, dst_p),
                   ms=median_ms(torch, lambda: ic.sweep_scatter(dst_k, *args), 10,
                                setup=dst_k.zero_),
                   plain_ms=median_ms(torch, lambda: ic.sweep_scatter_plain(
                       dst_p, *args), 1, setup=dst_p.zero_),
                   **k2_bound(mode, combined, xt, ks, imeta, dmeta, tiles, n2f, inv,
                              floor_ms, kern))
        assert one["max_abs_err"] < TOL, (name, one)
        rec["launches"].append(one)
        del dst_k, dst_p
    for key in ("ms", "plain_ms", "bound_ms", "roofline_ms"):
        if all(key in one for one in rec["launches"]):
            rec[key + "_sum"] = sum(one[key] for one in rec["launches"])
    return rec


class capture_destripe:
    """While active, keep the DestripeProblem that imdestripe.main makes (its
    device cost, map and upload times) in `.problem`, and the host seconds
    of main's other steps in `.times`: loading the SCAs (FITS reads, WCS
    gains, object masks), the overlap matrix and conjugate gradient."""

    def __enter__(self):
        from pyimcom_tpu_torch import imdestripe
        from pyimcom_tpu_torch.utils import compareutils

        self.problem, self.times = None, {}
        self._saved = [(imdestripe, "DestripeProblem"), (imdestripe, "get_scas"),
                       (imdestripe, "conjugate_gradient"),
                       (compareutils, "get_overlap_matrix")]
        self._saved = [(m, k, getattr(m, k)) for m, k in self._saved]
        outer = self

        class Captured(imdestripe.DestripeProblem):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                outer.problem = self

        def timed(name, fn):
            def run(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    outer.times[name] = time.perf_counter() - t0
            return run

        imdestripe.DestripeProblem = Captured
        imdestripe.get_scas = timed("get_scas_s", imdestripe.get_scas)
        imdestripe.conjugate_gradient = timed("cg_s", imdestripe.conjugate_gradient)
        compareutils.get_overlap_matrix = timed("overlap_s", compareutils.get_overlap_matrix)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def bilinear_records(torch, dev, dc, floor_ms, parent_k4, k4_build, reps=20):
    """K3 and K4 on the first pair of a DestripeCost `dc` (the neighbour's
    image and gain at the pair map's positions, on the target's pixel grid
    as the cost passes them): device times,
    errors against the plain versions, bounds, and the library times of
    torch.nn.functional.grid_sample (bilinear, zeros, align_corners=True)
    and of its input gradient, which compute the unweighted gather and its
    adjoint where 0 <= floor(x) <= nx - 2 and 0 <= floor(y) <= ny - 2: they
    are timed on the pair's points inside that region (`library_points`),
    and so is each kernel doing the library's work there, without a gain and
    writing its result (`library_work_ms`; for K4 a 1-D stream).
    K3 runs as the main path runs it, adding into an accumulator; its bytes
    are x, y and the accumulator read and written (32 a query), the image and
    the gain once; K4's the values, x and y (24 a query), the gain once and
    the output written once.  Operations: GATHER_FLOP / ADJOINT_FLOP an
    in-bounds query.  K4 also gets its tiling, its shared memory, its ptxas
    registers and spills (`k4_build`), its global-route tiles on this pair
    (equal to predict_global_tiles), and, where `parent_k4` is built, the
    earlier revision's time and error on the same inputs, each timed with
    its output's zero fill, alternately with the new K4."""
    import torch.nn.functional as F

    from pyimcom_tpu_torch.ops import bilinear, bilinear_cuda as bc

    _i, j = dc.pairs[0]
    img, gain, x, y = dc.imgs[j], dc.ge[j], dc.xf[0], dc.yf[0]
    ny, nx = img.shape
    n, npix = x.numel(), ny * nx
    inb = bilinear.in_bounds(x, y, (ny, nx))
    n_in = int(inb.sum())
    v = torch.as_tensor(np.random.default_rng(20261017).normal(size=x.shape), device=dev)
    acc = torch.zeros(x.shape, dtype=torch.float64, device=dev)
    got3 = bc.bilinear_gather(img, x, y, gain, out=acc.clone())
    want3 = bilinear.bilinear_gather_plain(img, x, y, gain)
    bc.reset_global_tiles()
    got4 = bc.bilinear_scatter_adjoint(v, x, y, (ny, nx), gain)
    global_tiles = bc.global_tiles(dev)
    want4 = bilinear.bilinear_scatter_adjoint_plain(v, x, y, (ny, nx), gain)
    torch.cuda.synchronize()
    # the library on the points inside its region, in its normalised coordinates
    xs, ys, vs = x[inb], y[inb], v[inb].reshape(1, 1, 1, -1)
    grid = torch.stack([2 * xs / (nx - 1) - 1, 2 * ys / (ny - 1) - 1], -1).reshape(1, 1, -1, 2)
    inp = img.reshape(1, 1, ny, nx).clone().requires_grad_(True)
    out_gs = F.grid_sample(inp, grid, mode="bilinear", padding_mode="zeros",
                           align_corners=True)
    lib_err = rel_err(torch, out_gs.detach().reshape(-1), bc.bilinear_gather(img, xs, ys))

    def lib_gather():
        with torch.no_grad():
            F.grid_sample(inp, grid, mode="bilinear", padding_mode="zeros", align_corners=True)

    def lib_adjoint():
        torch.autograd.grad(out_gs, inp, vs, retain_graph=True)

    def k4():
        bc.bilinear_scatter_adjoint(v, x, y, (ny, nx), gain)

    vflat = vs.reshape(-1)
    common = dict(pair=list(dc.pairs[0]), image=[ny, nx], queries=n, in_bounds=n_in,
                  library_points=n_in, library_vs_unweighted_K3=lib_err,
                  launch_floor_ms=floor_ms)
    k3 = dict(common, mode="accumulate, gain", max_abs_err=rel_err(torch, got3, want3),
              ms=median_ms(torch, lambda: bc.bilinear_gather(img, x, y, gain, out=acc), reps,
                           setup=acc.zero_),
              plain_ms=median_ms(torch, lambda: bilinear.bilinear_gather_plain(
                  img, x, y, gain), 3),
              library_ms=median_ms(torch, lib_gather, reps),
              library_work_ms=median_ms(torch, lambda: bc.bilinear_gather(img, xs, ys), reps),
              **bounds(8 * (4 * n + 2 * npix), GATHER_FLOP * n_in, floor_ms))
    k4_times = device_times(torch, k4, reps)
    k4_rec = dict(common, mode="gain, (ny, nx) query grid",
                  max_abs_err=rel_err(torch, got4, want4),
                  tile=list(bc.adjoint_tile(bc.query_grid(x)[0])), box_cap=bc.ADJOINT_BOX_CAP,
                  shared_bytes=8 * bc.ADJOINT_BOX_CAP, **k4_build,
                  global_tiles=global_tiles,
                  predicted_global_tiles=bc.predict_global_tiles(x, y, (ny, nx)))
    assert k4_rec["global_tiles"] == k4_rec["predicted_global_tiles"], k4_rec
    if parent_k4 is not None:
        out_p = torch.empty((ny, nx), dtype=torch.float64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def parent():
            out_p.zero_()
            err = parent_k4(v.data_ptr(), gain.data_ptr(), ny, nx, x.data_ptr(), y.data_ptr(),
                            n, out_p.data_ptr(), stream)
            assert err == 0, err
        parent()
        torch.cuda.synchronize()
        k4_rec["parent_max_abs_err"] = rel_err(torch, out_p, want4)
        assert k4_rec["parent_max_abs_err"] < TOL, k4_rec
        parent_times = device_times(torch, parent, reps)
        k4_times += device_times(torch, k4, reps)
        parent_times += device_times(torch, parent, reps)
        k4_rec["parent_ms"] = statistics.median(parent_times)
    k4_rec.update(ms=statistics.median(k4_times),
                  plain_ms=median_ms(torch, lambda: bilinear.bilinear_scatter_adjoint_plain(
                      v, x, y, (ny, nx), gain), 3),
                  library_ms=median_ms(torch, lib_adjoint, reps),
                  library_work_ms=median_ms(torch, lambda: bc.bilinear_scatter_adjoint(
                      vflat, xs, ys, (ny, nx)), reps),
                  **bounds(8 * (3 * n + 2 * npix), ADJOINT_FLOP * n_in, floor_ms))
    k4_rec["share_of_roofline"] = k4_rec["roofline_ms"] / k4_rec["ms"]
    for rec in (k3, k4_rec):
        assert rec["max_abs_err"] < TOL, rec
    return k3, k4_rec


def trace_kernels(torch, fn, top=12):
    """One call of fn() under torch.profiler, after a warm-up: the device
    time of every kernel by name (ms, launches), the `top` longest, and
    their sum; None where the trace shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return profile_rows(prof, top)


def profile_rows(prof, top=12):
    """The device time of every kernel of a torch.profiler trace by name
    (ms, launches), the `top` longest, their sum and their launches; None
    where the trace shows no device time."""
    rows = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            rows.append({"kernel": e.key[:120], "launches": e.count, "ms": us / 1e3})
    rows.sort(key=lambda r: -r["ms"])
    total = sum(r["ms"] for r in rows)
    if total <= 0:
        return None
    return {"device_ms": total, "kernels": len(rows),
            "launches": sum(r["launches"] for r in rows), "top": rows[:top]}


def striped_survey(root):
    """The destripe phase's survey: build_survey(n_obs=6) less the image and
    mask of its fourth F184 exposure (3 F184 SCAs at 4088^2, 6 ordered
    pairs), a clean copy of each L2 image under root/clean, and row stripes
    injected into the L2 images as scripts/run_chained_pipeline.py does
    (pipeline.inject_stripes).  Returns (config dict, the L2 paths)."""
    from survey_fixture_torch import build_survey

    from pyimcom_tpu_torch.pipeline import inject_stripes, raw_images

    cfg = build_survey(root, n_obs=6, extrainput=["cstar14"])
    for p in (root / "in").glob("sim_L2_F184_3_*.fits"):
        p.unlink()
    raw = [Path(p) for p in raw_images(root)]
    inject_stripes(root, raw)
    return cfg, raw


def destripe_inputs(root, raw, dsdir, variant):
    """An input directory for one coadd of the destripe phase: the masks
    linked, each L2 image from the clean copy, the striped file or the
    destriped image (under the original L2 name, with its header, as
    scripts/run_chained_pipeline.py feeds it back)."""
    import re

    from pyimcom_tpu_torch.fitsio import HDUList, Header, ImageHDU, fits_read, fits_write

    vin = root / f"in_{variant}"
    vin.mkdir()
    for p in (root / "in").iterdir():
        if "_mask" in p.name:
            (vin / p.name).symlink_to(p)
    for p in raw:
        if variant == "clean":
            shutil.copy(root / "clean" / p.name, vin / p.name)
        elif variant == "striped":
            shutil.copy(p, vin / p.name)
        else:
            name = re.search(r"(\w\d+)_(\d+)_(\d+)", p.name).group(0)
            g = fits_read(Path(dsdir) / f"ds_{name}.fits")
            fits_write(vin / p.name, HDUList([ImageHDU(np.asarray(g[0].data, np.float32),
                                                       header=Header(g[0].header))]))
    return vin


def phase_destripe(torch, dev, floor_ms, parent_k4, k4_build):
    """imdestripe.main on 3 striped F184 SCAs at 4088^2 (6 ordered pairs)
    with 5 CG iterations, object mask and WCS gain on; K3 and K4 at the
    phase's shapes; the kernel route of the cost against the plain route;
    then the bench block coadded from the clean, striped and destriped
    inputs.  Returns (K3, K4 records, the main path's launches)."""
    from pyimcom_tpu_torch import imdestripe
    from pyimcom_tpu_torch.bench import quality_check
    from pyimcom_tpu_torch.config import Config
    from pyimcom_tpu_torch.fitsio import fits_read
    from pyimcom_tpu_torch.ops import bilinear_cuda
    from pyimcom_tpu_torch.pipeline import destripe_quality

    root = WORK / "destripe"
    root.mkdir()
    t0 = time.perf_counter()
    cfg_dict, raw = striped_survey(root)
    survey_s = time.perf_counter() - t0
    dsdir = str(root / "ds")
    d = dict(cfg_dict, DSOUT=[dsdir, "ds"], DSOBSFILE=str(root / "in" / "sim_L2_*[0-9].fits"))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    bilinear_cuda.reset_launch_counts()
    bilinear_cuda.reset_global_tiles()
    t0 = time.perf_counter()
    with capture_destripe() as cap:
        params, history = imdestripe.main(Config(d), maxiter=5)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = dict(bilinear_cuda.launches)
    global_tiles = bilinear_cuda.global_tiles(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    assert all(k > 0 for k in launches.values()), launches
    prob = cap.problem
    dc = prob.device_cost
    assert len(dc.pairs) == 6 and dc.imgs.shape == (3, 4088, 4088), (dc.pairs, dc.imgs.shape)

    cost0 = prob.cost(np.zeros_like(params))
    ts = [h["t"] for h in history]
    p_rand = torch.as_tensor(np.random.default_rng(5).normal(scale=0.01, size=params.size),
                             device=dev)
    t_host = time.perf_counter()
    prob.cost_and_grad(p_rand.cpu().numpy())
    cg_host_s = time.perf_counter() - t_host
    # the whole cost and gradient enqueue for ~2 ms of host time: the sleep
    # ahead of the timed calls is 20 times the kernels'
    cg_ms = statistics.median(device_times(torch, lambda: dc.value_and_grad(p_rand), 5,
                                           sleep=20 * SLEEP_CYCLES))
    trace = trace_kernels(torch, lambda: dc.value_and_grad(p_rand))
    routes = {}
    for name, p in (("zero", torch.zeros_like(p_rand)), ("random", p_rand)):
        e_k, g_k = dc.value_and_grad(p)
        e_p, g_p = dc.value_and_grad(p, plain=True)
        routes[name] = {"cost_rel": abs(float(e_k - e_p)) / abs(float(e_p)),
                        "grad_max_excess": float(((g_k - g_p).abs() - 1e-9 * g_p.abs()).max()),
                        "grad_scale": float(g_p.abs().max())}
        assert routes[name]["cost_rel"] < 1e-12 and routes[name]["grad_max_excess"] <= 1e-12, \
            routes
    quality = destripe_quality(root, raw, dsdir)
    improved = sum(q["destriped"] < 0.5 * q["striped"] for q in quality.values())
    emit({"phase": "destripe", "scas": list(quality), "pairs": len(dc.pairs),
          "image": list(dc.imgs.shape[1:]), "survey_s": survey_s, "main_s": main_s,
          **prob.times, **cap.times, "max_memory_allocated_GiB": peak / 2 ** 30,
          "cg_iterations": len(history),
          "cg_iter_s": [b - a for a, b in zip([0.0] + ts[:-1], ts)],
          "cost_start": cost0, "cost_end": history[-1]["cost"], "launches": launches,
          "K4_global_route_tiles": global_tiles,
          "cost_and_grad_device_ms": cg_ms, "cost_and_grad_host_s": cg_host_s,
          "cost_and_grad_trace": trace if trace is not None else "not measured",
          "routes": routes, "row_median_std": quality, "improved": improved})
    assert len(quality) == 3 and history[-1]["cost"] < cost0, quality
    assert improved >= len(quality) // 2, quality

    # ---- K3 and K4 alone at the phase's shapes ----
    k3, k4 = bilinear_records(torch, dev, dc, floor_ms, parent_k4, k4_build)
    emit({"phase": "bilinear_kernels", "criterion": TOL, "K3": k3, "K4": k4})
    del cap.problem, prob, dc
    torch.cuda.empty_cache()

    # ---- the bench block from the clean, striped and destriped inputs ----
    runs = {}
    for variant in ("clean", "striped", "destriped"):
        vin = destripe_inputs(root, raw, dsdir, variant)
        (root / f"cache_{variant}").mkdir()
        blk, out, t_blk, blk_launches = run_block(
            cfg_dict, f"_ds_{variant}", INDATA=[str(vin), "L2_fits"],
            INLAYERCACHE=str(root / f"cache_{variant}" / "in"))
        SL1, uc_med = quality_check(out)
        hdus = fits_read(out)
        finite = all(bool(np.all(np.isfinite(np.asarray(h.data)))) for h in hdus
                     if getattr(h, "data", None) is not None
                     and np.asarray(h.data).dtype.kind in "fiu")
        runs[variant] = dict(stamps=len(blk.stamp_stats), block_s=t_blk, SL1=SL1,
                             uc_median=uc_med, finite=finite, launches=blk_launches,
                             sci=np.asarray(hdus[0].data[:, 0], np.float64))
    rms = {v: float(np.sqrt(np.mean((runs[v]["sci"] - runs["clean"]["sci"]) ** 2)))
           for v in ("striped", "destriped")}
    uc = [r["uc_median"] for r in runs.values()]
    emit({"phase": "destripe_coadd", "rms_vs_clean": rms,
          **{v: {k: r[k] for k in r if k != "sci"} for v, r in runs.items()}})
    assert all(r["stamps"] == 16 and r["finite"] for r in runs.values()), runs
    assert max(uc) - min(uc) <= 1e-6 * min(uc), uc
    assert rms["destriped"] < rms["striped"], rms
    return k3, k4, launches


def phase_mosaic_chain():
    """pyimcom_tpu_torch.pipeline with scripts/run_chained_pipeline.py's
    defaults and --n-obs 6, its launch counts set to 0 just before and read
    just after; the criteria of the module docstring.  Returns its line."""
    from pyimcom_tpu_torch import pipeline
    from pyimcom_tpu_torch.fitsio import fits_read
    from pyimcom_tpu_torch.ops import bilinear_cuda, interp_cuda

    interp_cuda.reset_launch_counts()
    bilinear_cuda.reset_launch_counts()
    res = pipeline.run(WORK / "mosaic_chain", n_obs=6, report=False)
    in_process = {**interp_cuda.launches, **bilinear_cuda.launches}
    finite = {Path(p).name: all(bool(np.all(np.isfinite(np.asarray(h.data))))
                                for h in fits_read(p) if getattr(h, "data", None) is not None
                                and np.asarray(h.data).dtype.kind in "fiu")
              for p in res["coadd_block_s"]}
    emit({"phase": "mosaic_chain", **res, "launches_in_process": in_process,
          "finite": finite, "report": "left out: the card's machine has no matplotlib"})
    st = res["launches"]
    assert st["destripe"]["bilinear_gather"] > 0 and st["destripe"]["bilinear_scatter_adjoint"] > 0
    assert st["layers"]["interp_d5512_dense"] > 0, st["layers"]
    assert all(st["coadd"][k] > 0 for k in family_kernels("D5512")), st["coadd"]
    assert res["destriped_2x"] >= len(res["destripe_row_median_std"]) // 2
    assert len(finite) == 4 and all(finite.values()), finite
    assert all(uc < UC_MAX for uc in res["UC_median_blocks"].values()), res["UC_median_blocks"]
    assert abs(res["star_SL1"] - 1.0) < CHAIN_SL1_TOL, res["star_SL1"]
    for name, check in res["compression"].items():
        assert sorted(check["layers"]) == [1, 2] and all(check["equal"].values()), (name, check)
        assert all(r["max_abs_err"] <= r["bound"] for r in check["layers"].values()), \
            (name, check)
    return res


def family_kernels(kern):
    """The launch counts' names of K1 and K2 (pool, B) of family `kern`."""
    from pyimcom_tpu_torch.ops import interp_cuda as ic

    return [ic.K1[kern], ic.sweep_kernel(kern, 0), ic.sweep_kernel(kern, 1)]


def run_block(cfg_dict, suffix, block_kw=None, no_system=False, **over):
    """One Block on the card, with the kernel launch counts set to 0 just
    before it and read just after; returns (block, output path, seconds,
    launches).  Every kernel of the path -- K1 and K2 of its PSFINTERP
    family -- must have launched and K2 of the other family not, except in
    a block that builds no system (Empirical without quality control),
    which must launch none.  `block_kw` goes to Block (checkpoint_sec,
    pool_budget_bytes)."""
    import torch

    from pyimcom_tpu_torch.coadd import Block
    from pyimcom_tpu_torch.config import Config
    from pyimcom_tpu_torch.ops import interp_cuda

    d = dict(cfg_dict, **over)
    d["OUT"] = d["OUT"] + suffix
    torch.cuda.synchronize()
    interp_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    blk = Block(cfg=Config(d), this_sub=1, device="cuda", **(block_kw or {}))
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    launches = dict(interp_cuda.launches)
    kern = d.get("PSFINTERP", "D5512")
    other = "G4460" if kern == "D5512" else "D5512"
    if no_system:
        assert all(n == 0 for n in launches.values()), (suffix, launches)
    else:
        assert all(launches[k] > 0 for k in family_kernels(kern)), (suffix, launches)
        assert all(launches[k] == 0 for k in family_kernels(other)[1:]), (suffix, launches)
    return blk, d["OUT"] + "_00_01.fits", t, launches


def compare_blocks(path_a, path_b):
    """The largest science difference of two output blocks over the first
    one's scale, and the largest difference of their quantized maps (LSB)."""
    from pyimcom_tpu_torch.fitsio import fits_read

    fa, fb = fits_read(path_a), fits_read(path_b)
    a, b = (np.asarray(f[0].data, np.float64) for f in (fa, fb))
    maps = {}
    for h in fa[1:]:
        name = h.header.get("EXTNAME")
        if name in ("FIDELITY", "SIGMA", "KAPPA", "INWTSUM", "EFFCOVER"):
            maps[name] = int(np.abs(np.asarray(h.data, np.int64)
                                    - np.asarray(fb[name].data, np.int64)).max())
    return dict(science_rel=float(np.abs(b - a).max() / np.abs(a).max()), maps_lsb=maps)


def checkpoint_child(cfg_json, die_after):
    """One run of the bench block with a snapshot after every drained group
    (checkpoint_sec=0), in a process of its own: with `die_after` > 0 the
    process ends with os._exit(17) right after that many snapshots (a kill:
    no cleanup, no output file); with 0 it resumes from the snapshot it
    finds and prints one JSON line of what it did."""
    import os

    import torch

    from pyimcom_tpu_torch.coadd import Block
    from pyimcom_tpu_torch.config import Config

    saves = []
    orig = Block._maybe_ckpt

    def counted(self):
        orig(self)
        saves.append(self._ckpt_base + self._groups_drained)
        if len(saves) == die_after:
            print(json.dumps({"killed_after_groups": saves}), flush=True)
            os._exit(17)

    Block._maybe_ckpt = counted
    t0 = time.perf_counter()
    blk = Block(cfg=Config(json.loads(Path(cfg_json).read_text())), this_sub=1,
                device="cuda", checkpoint_sec=0)
    torch.cuda.synchronize()
    print(json.dumps({"resumed_after_groups": blk._ckpt_base, "block_s": time.perf_counter() - t0,
                      "stamps": len(blk.stamp_stats), "snapshots": saves,
                      "checkpoint_phase": blk.phase_times().get("block.checkpoint")}), flush=True)
    return 0


def phase_checkpoint(cfg_dict, warm_out):
    """The bench block killed after its 2nd snapshot in a child process,
    then resumed in a fresh one; held to the uninterrupted warm block."""
    import os

    d = dict(cfg_dict, OUT=cfg_dict["OUT"] + "_ckpt")
    cfg_json = WORK / "ckpt_cfg.json"
    cfg_json.write_text(json.dumps(d))
    out = d["OUT"] + "_00_01.fits"
    snap = d["OUT"] + "_00_01.ckpt.npz"

    def child(die_after):
        code = ("import sys, chip_smoke; "
                f"sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'tests')!r}]; "
                f"sys.exit(chip_smoke.checkpoint_child({str(cfg_json)!r}, {die_after}))")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                              text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        return proc.returncode, json.loads(lines[-1]) if lines else None, \
            time.perf_counter() - t0, proc.stderr[-2000:]

    rc_kill, killed, t_kill, err = child(2)
    assert rc_kill == 17 and killed is not None, (rc_kill, err)
    assert os.path.exists(snap) and not os.path.exists(out), (snap, out)
    with np.load(snap) as z:
        groups_done = int(z["groups_done"])
    rc, resumed, t_res, err = child(0)
    assert rc == 0 and resumed is not None, (rc, err)
    cmp = compare_blocks(warm_out, out)
    rec = {"phase": "checkpoint", "killed": killed, "kill_process_s": t_kill,
           "snapshot_groups_done": groups_done, **resumed, "resume_process_s": t_res,
           "snapshot_removed": not os.path.exists(snap), "vs_uninterrupted": cmp}
    emit(rec)
    assert groups_done == 2 and resumed["resumed_after_groups"] == 2, rec
    assert resumed["stamps"] == 8 and rec["snapshot_removed"], rec
    assert cmp["science_rel"] < TOL and max(cmp["maps_lsb"].values()) <= 1, rec


def phase_runner(cfg_dict, warm_out, stop2_out):
    """The runner's command line, each run a process of its own: block 1 of
    the bench survey, held to the warm bench block; the same command again,
    which must skip the finished block; then --all --workers 2 at STOP 2
    (the forkserver pool, two blocks at a time on the card): every block
    written, block 1 held to the in-process STOP-2 Cholesky block."""
    import os

    def runner(name, d, *flags):
        cfg_json = WORK / f"{name}_cfg.json"
        cfg_json.write_text(json.dumps(d))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "pyimcom_tpu_torch.runner", str(cfg_json),
                               *flags], cwd=REPO, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, (name, flags, proc.returncode, proc.stderr[-2000:])
        return time.perf_counter() - t0, proc.stdout

    one = dict(cfg_dict, OUT=cfg_dict["OUT"] + "_runner")
    out = one["OUT"] + "_00_01.fits"
    t_block, _said = runner("runner", one, "--block", "1")
    written = os.path.getmtime(out)
    t_skip, said = runner("runner", one, "--block", "1")
    skipped = "already done" in said and os.path.getmtime(out) == written
    cmp = compare_blocks(warm_out, out)

    mosaic = dict(cfg_dict, STOP=2, OUT=cfg_dict["OUT"] + "_mosaic")
    t_all, _said = runner("mosaic", mosaic, "--all", "--workers", "2")
    nb = mosaic["BLOCK"]
    outs = [mosaic["OUT"] + f"_{i:02d}_{j:02d}.fits" for i in range(nb) for j in range(nb)]
    cmp_all = compare_blocks(stop2_out, mosaic["OUT"] + "_00_01.fits")
    rec = {"phase": "runner", "block_process_s": t_block, "rerun_process_s": t_skip,
           "rerun_skipped": skipped, "vs_warm_bench_block": cmp,
           "all_workers_2_process_s": t_all, "blocks": len(outs),
           "blocks_written": sum(os.path.exists(p) for p in outs),
           "block_1_vs_in_process": cmp_all}
    emit(rec)
    assert skipped and rec["blocks_written"] == len(outs), rec
    for c in (cmp, cmp_all):
        assert c["science_rel"] < TOL and max(c["maps_lsb"].values()) <= 1, rec


def phase_pool_budget(torch, dev, cfg_dict):
    """Production geometry at STOP 164 (a row of 40 groups and the first
    group of the second), Cholesky: with the default budget, then with a
    third of that run's retained peak; the second held to the first."""
    runs = {}
    for name in ("default", "third"):
        kw = {} if name == "default" else \
            {"pool_budget_bytes": runs["default"]["retained_peak_bytes"] / 3}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        blk, out, t, launches = run_block(cfg_dict, "_pool" + name, block_kw=kw,
                                          **dict(PROD, STOP=POOL_STOP))
        st = blk.pool_stats
        runs[name] = dict(
            budget_bytes=st["budget_bytes"], retained_peak_bytes=st["peak_bytes"],
            retained_after_rows_bytes=st["retained"][POOL_ROW - 1::POOL_ROW],
            evictions=st["evictions"], evicted_bytes=st["evicted_bytes"],
            recomputed_submatrices=st["recomputed"],
            max_memory_allocated_GiB=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            memory_reserved_GiB=torch.cuda.memory_reserved(dev) / 2 ** 30,
            stamps=len(blk.stamp_stats), block_s=t,
            s_per_stamp=t / max(len(blk.stamp_stats), 1), launches=launches, out=out,
            phases=phase_times(blk), retained_bytes=st["retained"])
        del blk
    cmp = compare_blocks(runs["default"]["out"], runs["third"]["out"])
    extra = {k: runs["third"]["launches"][k] - runs["default"]["launches"][k]
             for k in runs["third"]["launches"]}
    emit({"phase": "pool_budget", "stop": POOL_STOP,
          **{k: {kk: v for kk, v in r.items() if kk != "out"} for k, r in runs.items()},
          "extra_launches": extra, "third_vs_default": cmp})
    assert runs["third"]["evictions"] > 0 and runs["third"]["recomputed_submatrices"] > 0, runs
    assert all(r["stamps"] == POOL_STOP for r in runs.values()), runs
    assert cmp["science_rel"] < TOL and max(cmp["maps_lsb"].values()) <= 1, cmp


def phase_times(blk):
    return {k: {"host_s": round(v["host_s"], 4), "device_ms": round(v["device_ms"], 3),
                "calls": v["calls"]} for k, v in blk.phase_times().items()}


def solve_ms_per_stamp(blk):
    """CUDA-event milliseconds of the solve phase per coadded stamp."""
    return blk.phase_times()["stamp.solve"]["device_ms"] / max(len(blk.stamp_stats), 1)


def run_production(torch, dev, cfg_dict, phase, suffix, **over):
    """One 2x2 group at production geometry; prints and returns its phase
    line."""
    from pyimcom_tpu_torch.fitsio import fits_read

    torch.cuda.reset_peak_memory_stats(dev)
    prod, out_p, t_prod, launches = run_block(cfg_dict, suffix, **PROD, **over)
    hdus = fits_read(out_p)
    maps = {h.header.get("EXTNAME") or "SCI": np.asarray(h.data) for h in hdus
            if getattr(h, "data", None) is not None and np.asarray(h.data).dtype.kind in "fiu"
            and np.asarray(h.data).ndim >= 2}
    finite = {k: bool(np.all(np.isfinite(v))) for k, v in maps.items()}
    rec = {"phase": phase, "solve": over or "Cholesky", "stamps": len(prod.stamp_stats),
           "block_s": t_prod, "s_per_stamp": t_prod / max(len(prod.stamp_stats), 1),
           "solve_ms_per_stamp": solve_ms_per_stamp(prod),
           "n": [s["n"] for s in prod.stamp_stats],
           "uc_median": [s["uc_median"] for s in prod.stamp_stats],
           "sigma_median": [s["sigma_median"] for s in prod.stamp_stats],
           "max_memory_allocated_GiB": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "finite": finite, "launches": launches, "phases": phase_times(prod)}
    emit(rec)
    assert len(prod.stamp_stats) == 4 and all(finite.values()), finite
    return rec


def phase_production_mixed(torch, dev, cfg_dict, f64):
    """The production group at SOLVERPREC "mixed" (float32 factorization,
    float64 refinement) beside the float64 Cholesky group `f64` (its
    line): each stamp's U/C and Sigma medians within the bounds of
    tests/test_solvers.py::test_mixed_precision_matches_f64 for a
    production-like node (1e-6, 1e-4); then the solve alone at n = 5120
    (solve_alone)."""
    rec = run_production(torch, dev, cfg_dict, "production_mixed", "_prodmix",
                         SOLVERPREC="mixed")
    diff = {key: max(abs(a - b) for a, b in zip(rec[key], f64[key]))
            for key in ("uc_median", "sigma_median")}
    alone = solve_alone(torch, dev)
    emit({"phase": "production_mixed_vs_f64", "median_abs_diff": diff,
          "s_per_stamp": {"mixed": rec["s_per_stamp"], "f64": f64["s_per_stamp"]},
          "solve_ms_per_stamp": {"mixed": rec["solve_ms_per_stamp"],
                                 "f64": f64["solve_ms_per_stamp"]}, "solve_alone": alone})
    assert rec["n"] == f64["n"], (rec["n"], f64["n"])
    assert diff["uc_median"] < 1e-6 and diff["sigma_median"] < 1e-4, diff
    assert alone["UC_max_abs_diff"] < 1e-6 and alone["Sigma_max_abs_diff"] < 1e-4, alone


def solve_alone(torch, dev, n=5120, m=1156, reps=3):
    """cholesky_solve and cholesky_solve_mixed alone on the card at the
    production group's size (PERF.md's solve-alone system: n 5120, m 1156, one
    target PSF, KAPPAC [5e-4]; A = X X^T / n + 1e-3 I of a seeded normal X,
    -B/2 seeded normal): the median of `reps` calls after a warm-up, CUDA
    events around each call (the solvers read the factorization's status
    on the host, so the time holds that sync), and the largest differences
    of U/C and Sigma."""
    from pyimcom_tpu_torch.solvers import cholesky_solve, cholesky_solve_mixed

    g = torch.Generator(device=dev)
    g.manual_seed(20261018)
    X = torch.randn((n, n), dtype=torch.float64, device=dev, generator=g)
    A = X @ X.T / n + 1e-3 * torch.eye(n, dtype=torch.float64, device=dev)
    del X
    mb = torch.randn((1, m, n), dtype=torch.float64, device=dev, generator=g) / n
    C = torch.ones(1, dtype=torch.float64, device=dev)
    kC = torch.tensor([5e-4], dtype=torch.float64, device=dev)
    out, ms = {}, {}
    for name, fn in (("f64", cholesky_solve), ("mixed", cholesky_solve_mixed)):
        fn(A, mb, C, kC, 1e-3, 1.0)
        times = []
        for _ in range(reps):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            out[name] = fn(A, mb, C, kC, 1e-3, 1.0)
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        ms[name] = statistics.median(times)
    # the least work: A, -B/2 and T once; the f64 solve's factorization
    # (n^3 / 3) and triangular solves (2 n^2 m); the mixed solve's f32
    # factorization and 1 + 2 solves, and its 2 f64 residual products
    # (2 m n^2 each), every operation at the card's 67 TFLOP/s
    nbytes = 8 * (n * n + 2 * m * n)
    flops = {"f64": n ** 3 / 3 + 2 * n * n * m,
             "mixed": n ** 3 / 3 + 3 * 2 * n * n * m + 2 * 2 * m * n * n}
    bounds_ = {k: bound(nbytes, f) for k, f in flops.items()}
    return {"n": n, "m": m, "ms": ms, "mixed_over_f64": ms["mixed"] / ms["f64"],
            "bound_ms": {k: b[0] for k, b in bounds_.items()},
            "bound_by": {k: b[1] for k, b in bounds_.items()},
            "UC_max_abs_diff": float((out["mixed"][3] - out["f64"][3]).abs().max()),
            "Sigma_max_abs_diff": float((out["mixed"][2] - out["f64"][2]).abs().max()),
            "T_max_abs_diff": float((out["mixed"][0] - out["f64"][0]).abs().max())}


def phase_g4460_block(cfg_dict, k1_caps):
    """The bench block with PSFINTERP G4460, warm (the bench block's layer
    cache; star injection is D5512 and does not run): K1 and K2 in their
    8-tap forms.  SL1 and the U/C median must equal the port's CPU record
    of the same block to 1e-8 relative.  Returns the first group's sweep
    plan (capture_first_plan)."""
    from pyimcom_tpu_torch.bench import quality_check

    with capture_first_plan() as cap, capture_k1("g4460", ["psf_sampling"], k1_caps):
        blk, out, t, launches = run_block(cfg_dict, "_g4460", PSFINTERP="G4460")
    SL1, uc = quality_check(out)
    rel = {"SL1": SL1 / CPU_RECORD_G4460["SL1"] - 1,
           "uc_median": uc / CPU_RECORD_G4460["uc_median"] - 1}
    emit({"phase": "g4460_block", "stamps": len(blk.stamp_stats), "block_s": t,
          "blocks_per_hour": 3600.0 / t, "SL1": SL1, "uc_median": uc,
          "cpu_record": CPU_RECORD_G4460, "rel_to_cpu_record": rel, "launches": launches,
          "phases": phase_times(blk)})
    assert len(blk.stamp_stats) == 16, blk.stamp_stats
    assert all(abs(v) < 1e-8 for v in rel.values()), rel
    return cap.plan, launches


class HostRSS:
    """While active, the resident set of this process, sampled every 10 ms
    on a thread (/proc/self/statm): `start_GiB` and `peak_GiB`."""

    def _rss(self):
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self._page / 2 ** 30

    def _watch(self):
        while not self._stop.wait(0.01):
            self.peak_GiB = max(self.peak_GiB, self._rss())

    def __enter__(self):
        import os
        import threading

        self._page = os.sysconf("SC_PAGE_SIZE")
        self.start_GiB = self.peak_GiB = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak_GiB = max(self.peak_GiB, self._rss())


class capture_imsubtract:
    """While active, one record per wing-subtraction task: each exposure
    that splitpsf.imsubtract.run_imsubtract handles, and each call made
    through `measure`.  A record holds the canvas side, the host seconds of
    the canvas geometry (CanvasGeometry: sky positions, pixel areas, block
    positions), the K1 launches of the wing canvases and their device time,
    the device time of the FFT convolutions, the task's seconds, its peak
    device memory and the process's resident set before and at its peak;
    the geometries made are in `.geometries`."""

    def __enter__(self):
        import torch

        from pyimcom_tpu_torch.ops import interp_cuda
        from pyimcom_tpu_torch.splitpsf import imsubtract as ims

        self.exposures, self.geometries, self.cur = [], [], None
        names = ("run_imsubtract", "fftconvolve_multi", "_interp_scattered", "CanvasGeometry")
        self._saved = [(ims, n, getattr(ims, n)) for n in names]
        orig = {n: f for _m, n, f in self._saved}
        self._torch, self._launches = torch, interp_cuda.launches
        outer = self

        def timed(key, fn):
            def run(*a, **kw):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                r = fn(*a, **kw)
                e1.record()
                outer.cur[key].append((e0, e1))
                return r
            return run

        class Geometry(orig["CanvasGeometry"]):
            def __init__(self, *a, **kw):
                t0 = time.perf_counter()
                super().__init__(*a, **kw)
                outer.cur["geometry_s"] += time.perf_counter() - t0
                outer.cur["canvas_side"] = self.A
                outer.geometries.append(self)

            def on_block(self, *a, **kw):
                t0 = time.perf_counter()
                r = super().on_block(*a, **kw)
                outer.cur["geometry_s"] += time.perf_counter() - t0
                return r

        def run_imsubtract(cfg, idsca, split_file, **kw):
            return outer.measure({"idsca": list(idsca)}, orig["run_imsubtract"], cfg, idsca,
                                 split_file, **kw)

        ims.run_imsubtract = run_imsubtract
        ims.fftconvolve_multi = timed("fft", orig["fftconvolve_multi"])
        ims._interp_scattered = timed("k1", orig["_interp_scattered"])
        ims.CanvasGeometry = Geometry
        return self

    def measure(self, rec, fn, *a, geometry=None, **kw):
        """fn(*a, **kw) as one task; its record is `rec` and the numbers
        above (the canvas side that of `geometry` where the task uses one it
        was given)."""
        torch = self._torch
        self.cur = {"geometry_s": 0.0, "k1": [], "fft": [],
                    "canvas_side": None if geometry is None else geometry.A}
        if geometry is not None:
            kw["geometry"] = geometry
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k1_before = self._launches["interp_g4460_dense"]
        t0 = time.perf_counter()
        with HostRSS() as rss:
            r = fn(*a, **kw)
            torch.cuda.synchronize()
        cur = self.cur
        self.exposures.append(dict(
            rec, result=r, seconds=time.perf_counter() - t0,
            canvas_side=cur["canvas_side"], host_geometry_s=cur["geometry_s"],
            k1_launches=self._launches["interp_g4460_dense"] - k1_before,
            k1_device_ms=sum(e0.elapsed_time(e1) for e0, e1 in cur["k1"]),
            fft_calls=len(cur["fft"]),
            fft_device_ms=sum(e0.elapsed_time(e1) for e0, e1 in cur["fft"]),
            max_memory_allocated_GiB=torch.cuda.max_memory_allocated() / 2 ** 30,
            host_rss_start_GiB=rss.start_GiB, host_rss_peak_GiB=rss.peak_GiB))
        return r

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def maps_finite(path):
    from pyimcom_tpu_torch.fitsio import fits_read

    return all(bool(np.all(np.isfinite(np.asarray(h.data)))) for h in fits_read(path)
               if getattr(h, "data", None) is not None
               and np.asarray(h.data).dtype.kind in "fiu")


def split_tasks(cfg_dict, legdir, obsids):
    """splitpsf.main as a job array: one process an observation (``python -m
    pyimcom_tpu_torch.splitpsf.splitpsf cfg.json``, one thread each), its
    INPSF directory holding only that observation's Legendre file, all
    writing INLAYERCACHE.psf/; returns the seconds of each task and of the
    array."""
    import os

    procs, t0 = {}, time.perf_counter()
    for obsid in obsids:
        task = Path(legdir) / f"task_{obsid:d}"
        task.mkdir()
        name = f"psf_polyfit_{obsid:d}.fits"
        (task / name).symlink_to(Path(legdir) / name)
        cfg_path = task / "cfg.json"
        cfg_path.write_text(json.dumps(dict(cfg_dict, INPSF=[str(task), *cfg_dict["INPSF"][1:]])))
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                   OPENBLAS_NUM_THREADS="1")
        procs[obsid] = (subprocess.Popen([sys.executable, "-m",
                                          "pyimcom_tpu_torch.splitpsf.splitpsf", str(cfg_path)],
                                         cwd=REPO, env=env, stdout=subprocess.DEVNULL), t0)
    secs = {}
    for obsid, (proc, start) in procs.items():
        assert proc.wait() == 0, (obsid, proc.returncode)
        secs[obsid] = time.perf_counter() - start
    return {"task_s": secs, "array_s": time.perf_counter() - t0}


def dir_bytes(path, pattern):
    return sum(p.stat().st_size for p in Path(path).glob(pattern))


def phase_psfsplit_loop(torch, dev, k1_caps, floor_ms, parent):
    """Config 3 as one run through the port's entries (module docstring,
    11; in .smoke_work/psfsplit/): Piff files -> piff_to_legendre_multi on
    the card -> splitpsf.main as a job array -> the iteration-0 block -> the
    wing subtraction of one SCA as a job-array task (``imsubtract cfg
    <sca>``) at the split files' oversampling with bin2x2 -> update_cube ->
    the iteration-1 block.  Returns (the task's launches, the iteration-0
    block's launches, its first K1 launch's record, its first group's K2
    record, the wing canvas's side and the binned kernel's)."""
    import importlib
    import re

    from survey_fixture_torch import (build_survey, field_chips, pixel_twice_sl1,
                                      write_piff_files)

    from pyimcom_tpu_torch.bench import uc_median
    from pyimcom_tpu_torch.fitsio import fits_read
    from pyimcom_tpu_torch.ops import interp_cuda
    from pyimcom_tpu_torch.pipeline import star_quality
    from pyimcom_tpu_torch.splitpsf import imsubtract
    from pyimcom_tpu_torch.utils import piffutils

    update_cube = importlib.import_module("pyimcom_tpu_torch.splitpsf.update_cube")
    root = WORK / "psfsplit"
    stages, t0 = {}, time.perf_counter()

    def stage(name):
        nonlocal t0
        stages[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    cfg_dict = build_survey(root, n_obs=8, extrainput=[], config_overrides=PSFSPLIT_OVERRIDES)
    ov = int(cfg_dict["INPSF"][2])
    piff_dir, legdir = root / "piff", root / "legendre"
    piff_dir.mkdir()
    legdir.mkdir()
    n_piff = write_piff_files(cfg_dict["INPSF"][0], piff_dir, ov=ov, order=1, grad=PIFF_GRAD,
                              seed=PIFF_SEED)
    stage("survey")

    chips = field_chips(cfg_dict)
    convert_s = {}
    for obsid, obs_chips in chips.items():
        t = time.perf_counter()
        piffutils.piff_to_legendre_multi(str(piff_dir / f"ffov_{obsid:d}.piff"),
                                         str(legdir / f"psf_polyfit_{obsid:d}.fits"),
                                         chips=obs_chips, device=dev, **C3_LEGENDRE)
        convert_s[obsid] = time.perf_counter() - t
    stage("legendre")
    # the first observation's conversion on the CPU route
    first_obs = min(chips)
    cpu_file = root / "legendre_cpu.fits"
    t = time.perf_counter()
    piffutils.piff_to_legendre_multi(str(piff_dir / f"ffov_{first_obs:d}.piff"), str(cpu_file),
                                     chips=chips[first_obs], device="cpu", **C3_LEGENDRE)
    cpu_s = time.perf_counter() - t
    got, want = fits_read(legdir / f"psf_polyfit_{first_obs:d}.fits"), fits_read(cpu_file)
    legendre = {"chips": chips, "card_s": convert_s, "cpu_route_s": cpu_s,
                "cube": list(np.shape(want[chips[first_obs][0]].data)),
                "OVSAMP": got[0].header.get("OVSAMP"),
                "headers_equal": [dict(g.header) for g in got] == [dict(w.header) for w in want],
                "card_vs_cpu_float32_spacings": {
                    sca: float(np.abs(np.asarray(got[sca].data, np.float64) - want[sca].data).max()
                               / np.spacing(np.float32(np.abs(want[sca].data[0]).max())))
                    for sca in chips[first_obs]},
                "bytes": dir_bytes(legdir, "psf_polyfit_*.fits")}
    cpu_file.unlink()
    stage("legendre_cpu_route")

    cache = str(root / "cache" / "in")
    d = dict(cfg_dict, INLAYERCACHE=cache, INPSF=[str(legdir), "L2_2506", ov],
             PSFSPLIT=PSFSPLIT)
    cfg_path = root / "cfg_split.json"
    cfg_path.write_text(json.dumps(d))
    tasks = split_tasks(d, legdir, sorted(chips))
    split_files = sorted(Path(cache + ".psf").glob("psf_*.fits"))
    sf = fits_read(split_files[0])
    nsca = int(sf[0].header["NSCA"])
    split = dict(count=len(split_files), NSCA=nsca, GSSKIP=int(sf[0].header["GSSKIP"]),
                 KERSKIP=int(sf[0].header["KERSKIP"]),
                 OVSAMP=sorted({fits_read(p)[0].header.get("OVSAMP") for p in split_files}),
                 finite=all(bool(np.all(np.isfinite(np.asarray(h.data))))
                            for p in split_files for h in list(fits_read(p))[1:]),
                 bytes=dir_bytes(cache + ".psf", "psf_*.fits"), **tasks)
    stage("split")

    with capture_first_plan() as plan_cap, capture_k1("psfsplit", ["psf_sampling"], k1_caps):
        blk0, out0, _t, launches0 = run_block(d, "_it0")
    stage("iteration0")

    pat = re.compile(r"_(\d{8})_(\d{2})\.fits$")
    per_sca = {}
    for p in Path(cache).parent.glob(Path(cache).name + "_*_*.fits"):
        m = pat.search(p.name)
        if m:
            per_sca.setdefault(int(m.group(2)), []).append(int(m.group(1)))
    sca = min(per_sca, key=lambda k: (len(per_sca[k]), k))
    d0 = dict(d, OUT=d["OUT"] + "_it0")
    cfg0_path = root / "cfg_it0.json"
    cfg0_path.write_text(json.dumps(d0))
    interp_cuda.reset_launch_counts()
    with capture_imsubtract() as cap, capture_k1("psfsplit", ["wing_canvas"], k1_caps,
                                                max_queries=1 << 22):
        assert imsubtract._cli([str(cfg0_path), str(sca), "--device", "cuda"]) == 0
    task_launches = dict(interp_cuda.launches)
    first = cap.exposures[0]
    orig = np.asarray(fits_read(first["result"].replace("_subI", ""))[0].data, np.float64)
    sub = np.asarray(fits_read(first["result"])[0].data, np.float64)
    diff = np.abs(orig - sub)
    # the canvas the split file's kernels give: oversampling OVSAMP / 2
    # (bin2x2), padded by half the binned kernel (wing_corrections)
    K, ov_b = imsubtract.wing_kernels(cache + f".psf/psf_{first['idsca'][0]:d}.fits", sca,
                                      bin2x2=True)
    pad = int(np.ceil(K.shape[-1] / 2 / ov_b))
    canvas = ov_b * (orig.shape[-1] + 2 * pad)
    stage("imsubtract")

    it = update_cube.main(str(cfg_path))
    stage("update")
    blk1, out1, _t, launches1 = run_block(d, "_it1")
    stage("iteration1")

    outs = {"it0": fits_read(out0), "it1": fits_read(out1)}
    hist = json.loads("".join(str(r) for r in outs["it1"]["OLDCFG"].data["text"]))
    quality = {k: dict(zip(("SL1", "VAR"), star_quality(p, d)), uc_median=uc_median(p),
                       finite=maps_finite(p)) for k, p in (("it0", out0), ("it1", out1))}
    sl1_pixel_twice = pixel_twice_sl1(d)
    rec = {"phase": "psfsplit_loop", "psfsplit": PSFSPLIT, "legendre_kw": C3_LEGENDRE,
           "stages_s": stages, "piff_files": n_piff, "legendre": legendre, "split": split,
           "sca": sca, "cached_exposures_per_sca": {k: len(v) for k, v in per_sca.items()},
           "kernels": {"oversampling": ov_b, "shape": list(K.shape)}, "canvas_side": canvas,
           "exposures": [{k: v for k, v in e.items() if k != "result"} for e in cap.exposures],
           "layers": int(orig.shape[0]), "image": list(orig.shape[1:]),
           "max_abs_delta": float(diff.max()), "median_abs_delta": float(np.median(diff)),
           "max_abs_cube": float(np.abs(orig).max()),
           "IMSBITER": [int(outs[k]["OLDCFG"].header["IMSBITER"]) for k in ("it0", "it1")],
           "iteration_after_update": it, "history_iteration0": hist[0]["iteration"],
           "quality": quality, "SL1_pixel_twice": sl1_pixel_twice,
           "task_launches": task_launches,
           "launches": {"it0": launches0, "it1": launches1},
           "stamps": [len(blk0.stamp_stats), len(blk1.stamp_stats)]}
    emit(rec)
    assert legendre["OVSAMP"] == ov and legendre["headers_equal"], legendre
    assert all(v <= 2 for v in legendre["card_vs_cpu_float32_spacings"].values()), legendre
    assert split["count"] >= 4 and split["GSSKIP"] == nsca and split["KERSKIP"] == 2 * nsca, split
    assert split["OVSAMP"] == [ov] and split["finite"], split
    assert rec["IMSBITER"] == [0, 1] and it == 1 and hist[0]["iteration"] == 0, rec
    assert ov_b == ov // 2 and orig.shape == sub.shape and orig.shape[1:] == (4088, 4088), rec
    assert all(e["canvas_side"] == canvas for e in cap.exposures), rec
    assert diff.max() > 0 and np.median(diff) < 0.5 * np.abs(orig).max(), rec
    # the Legendre cubes hold the Piff model's pixel response, and the split
    # convolves them with the pixel again (a fault both packages share,
    # ROADMAP.md queue 3): SL1 is held to its value for a pixel counted
    # twice, at the e2e bound
    assert all(q["finite"] and q["uc_median"] < UC_MAX
               and abs(q["SL1"] - sl1_pixel_twice) < CHAIN_SL1_TOL
               for q in quality.values()), (quality, sl1_pixel_twice)
    assert quality["it1"]["VAR"] < max(1.05 * quality["it0"]["VAR"], 1e-5), quality
    assert len(cap.exposures) >= 1 and all(e["k1_launches"] > 0 for e in cap.exposures), rec
    assert task_launches["interp_g4460_dense"] > 0, task_launches
    assert all(n == 0 for k, n in task_launches.items() if k != "interp_g4460_dense"), \
        task_launches
    k1 = k1_main_path(torch, dev, "psfsplit/psf_sampling", k1_caps.pop("psfsplit/psf_sampling"),
                      floor_ms, parent)
    emit({"phase": "k1_main_path", "criterion": TOL, **k1})
    k2 = k2_main_path(torch, dev, "psfsplit_group_1", plan_cap.plan, floor_ms)
    del plan_cap.plan
    emit({"phase": "k2_main_path", "criterion": TOL, **k2})
    return task_launches, launches0, k1, k2, (canvas, K.shape[-1])


def legendre_cost(torch, dev, order):
    """What config 3's conversion and split cost at Legendre order `order`
    (``python3 chip_smoke.py --legendre-order N``): the psfsplit survey's
    first observation converted on the card at the JAX defaults for stamp
    and oversampling, its seconds and file bytes; then the host seconds of
    one SCA's split (SplitPSF.build) for a converted chip and for a
    placeholder, and the bytes of a split file (three cubes an SCA).
    Prints its line."""
    from survey_fixture_torch import build_survey, field_chips, write_piff_files

    from pyimcom_tpu_torch.fitsio import fits_read
    from pyimcom_tpu_torch.splitpsf import splitpsf
    from pyimcom_tpu_torch.utils import piffutils

    root = WORK / "legendre_cost"
    cfg_dict = build_survey(root, n_obs=8, extrainput=[], config_overrides=PSFSPLIT_OVERRIDES)
    ov = int(cfg_dict["INPSF"][2])
    write_piff_files(cfg_dict["INPSF"][0], root, ov=ov, order=1, grad=PIFF_GRAD,
                     seed=PIFF_SEED)
    chips = field_chips(cfg_dict)
    obsid = min(chips)
    out = root / f"psf_polyfit_{obsid:d}.fits"
    kw = dict(C3_LEGENDRE, legendre_order=order)
    t = time.perf_counter()
    piffutils.piff_to_legendre_multi(str(root / f"ffov_{obsid:d}.piff"), str(out),
                                     chips=chips[obsid], device=dev, **kw)
    convert_s = time.perf_counter() - t
    f = fits_read(out)
    r2 = PSFSPLIT[1]
    small = int(np.ceil(r2 * ov * 2 + 4))
    pars = {"smallstamp_size": small + 8 - small % 8, "sigmaGamma": cfg_dict["EXTRASMOOTH"],
            "r_in": PSFSPLIT[0], "r_out": r2, "eps": PSFSPLIT[2], "oversamp": ov}
    split_s = {}
    for kind, sca in (("converted", chips[obsid][0]),
                      ("placeholder", 1 if chips[obsid][0] != 1 else 2)):
        t = time.perf_counter()
        sp = splitpsf.SplitPSF(np.asarray(f[sca].data, np.float64), None, pars)
        sp.build()
        split_s[kind] = time.perf_counter() - t
    nsca = int(f[0].header["NSCA"])
    cube_bytes = int(np.asarray(f[1].data).nbytes)
    rec = {"phase": "legendre_cost", "order": order, "legendre_kw": kw,
           "cube": list(np.shape(f[1].data)), "convert_s": convert_s,
           "legendre_file_bytes": out.stat().st_size, "sca_split_s": split_s,
           "split_file_bytes": 3 * nsca * cube_bytes,
           "split_file_s_one_process": nsca * split_s["placeholder"]}
    emit(rec)
    return rec


def fft_bounds(A, m):
    """Bounds of one convolution of fftconvolve_multi on an A^2 canvas with
    an m^2 kernel, in f64.  Bytes: `bound_ms`, the function's inputs read
    once and its valid output written once; `transforms_bound_ms`, each of
    its three transforms (canvas, kernel, inverse) reading its input and
    writing its output once, A (A/2 + 1) complex128 a spectrum, and the
    spectral product reading two spectra and writing one.  Operations: 2.5 N
    log2 N a real 2-D transform of N = A^2 points, three of them."""
    spec = 16 * A * (A // 2 + 1)
    valid = 8 * (A - m + 1) ** 2
    flops = 3 * 2.5 * A * A * np.log2(A * A)
    fn = bound(8 * A * A + 8 * m * m + valid, flops)
    tr = bound((8 * A * A + spec) + (8 * m * m + spec) + 3 * spec + (spec + 8 * A * A) + valid,
               flops)
    return {"bound_ms": fn[0], "bound_by": fn[1], "transforms_bound_ms": tr[0],
            "transforms_bound_by": tr[1]}


def phase_fftconv_full(torch, dev, loop):
    """One fftconvolve_multi on the card at the unbinned production canvas
    (FFT_SIDE^2, one 120^2 kernel; seeded random data made on the card):
    its device time (the second of two calls; the first plans cuFFT), its
    peak device memory, and the valid window of a 2048^2 crop against the
    CPU route to 1e-12 of scale; and the bounds of one convolution
    (fft_bounds) at this side and at the split-PSF loop's `loop` (canvas
    side, kernel side)."""
    from pyimcom_tpu_torch.splitpsf.imsubtract import fftconvolve_multi

    A, m, crop = FFT_SIDE, 120, 2048
    g = torch.Generator(device=dev)
    g.manual_seed(20261017)
    canvas = torch.randn((A, A), dtype=torch.float64, device=dev, generator=g)
    kernel = torch.randn((1, m, m), dtype=torch.float64, device=dev, generator=g)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    times, out = [], None
    for _ in range(2):
        out = None
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = fftconvolve_multi(canvas, kernel)
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    peak = torch.cuda.max_memory_allocated(dev)
    got = out[:, :crop - m + 1, :crop - m + 1].cpu()
    want = fftconvolve_multi(canvas[:crop, :crop].cpu(), kernel.cpu())
    rec = {"phase": "fftconv_full", "canvas": [A, A], "kernel": [m, m],
           "out": list(out.shape), "device_ms": times,
           "bounds": {str(A): fft_bounds(A, m), str(loop[0]): fft_bounds(*loop)},
           "inputs_GiB": base / 2 ** 30,
           "max_memory_allocated_GiB": peak / 2 ** 30,
           "crop": crop, "crop_vs_cpu": rel_err(torch, got, want),
           "finite": bool(torch.isfinite(out).all())}
    emit(rec)
    assert tuple(out.shape) == (1, A - m + 1, A - m + 1) and rec["finite"], rec
    assert rec["crop_vs_cpu"] < TOL, rec


def phase_g4460_kernels(torch, dev, k1_caps, plan, floor_ms):
    """K1<8> alone on its captured main-path launches -- PSF sampling of
    the G4460 bench block and the first wing canvas of the split-PSF loop's
    wing-subtraction task (at oversampling 3, at most 2^22 of its queries)
    -- and K2<8> (pool, B) on the G4460 bench block's first group, against
    their plain versions.  Returns (the K1 records, the K2 record)."""
    k1 = {key: k1_main_path(torch, dev, key, k1_caps.pop(key), floor_ms, None)
          for key in ("g4460/psf_sampling", "psfsplit/wing_canvas")}
    k2 = k2_main_path(torch, dev, "g4460_bench_group_1", plan, floor_ms)
    emit({"phase": "g4460_kernels", "criterion": TOL, "K1": k1, "K2": k2})
    return k1, k2


class capture_first_draw:
    """While active, keep the arguments of the first Piff draw of a block
    (coadd.draw_models, one call a PSF group) in `.first`: models, x, y,
    keywords."""

    def __enter__(self):
        from pyimcom_tpu_torch import coadd

        self._coadd, self._draw = coadd, coadd.draw_models
        self.first = None

        def draw(models, x, y, **kw):
            if self.first is None:
                self.first = (list(models), np.array(x), np.array(y), dict(kw))
            return self._draw(models, x, y, **kw)

        coadd.draw_models = draw
        return self

    def __exit__(self, *exc):
        self._coadd.draw_models = self._draw


def host_median_s(fn, reps=5):
    """Median host seconds of fn() (which returns host arrays) over `reps`
    calls after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def phase_piff_block(torch, dev, cfg_dict, bench, floor_ms, parent):
    """The bench block with Piff PSF files (module docstring, 11b): a first
    run, then the measured warm run, whose first K1 launch of PSF sampling
    and first group's K2 launches are held against their plain versions;
    one PSF group's draws timed and held to the CPU route.  `bench` holds
    the bench block's block_s, SL1 and uc_median.  Returns (the warm
    block's launches, the K1 record, the K2 record)."""
    from survey_fixture_torch import write_piff_files

    from pyimcom_tpu_torch.bench import quality_check
    from pyimcom_tpu_torch.ops.interp import grid_interp
    from pyimcom_tpu_torch.utils import piffutils

    piff_dir = WORK / "piff"
    piff_dir.mkdir()
    n_files = write_piff_files(cfg_dict["INPSF"][0], piff_dir, ov=cfg_dict["INPSF"][2],
                               order=1, grad=PIFF_GRAD, seed=PIFF_SEED)
    over = dict(INPSF=[str(piff_dir), "piff", PIFF_OV])
    _b, _o, t_first, first_launches = run_block(cfg_dict, "_piff1", **over)
    k1_caps = {}
    with capture_first_draw() as cap, capture_first_plan() as plan_cap, \
            capture_k1("piff", ["psf_sampling"], k1_caps):
        blk, out, t_block, launches = run_block(cfg_dict, "_piff", **over)
    SL1, uc_med = quality_check(out)
    times = phase_times(blk)

    models, x, y, kw = cap.first
    card = piffutils.draw_models(models, x, y, **kw)
    cpu = piffutils.draw_models(models, x, y, **dict(kw, device="cpu"))
    err = max(float(np.abs(a.astype(np.float64) - b).max()) for a, b in zip(card, cpu))
    spacing = float(np.spacing(np.float32(max(np.abs(b).max() for b in cpu))))
    # the group's interpolation alone: the survey's Piff files share one
    # grid size and spacing, so the group is one interpolation
    assert len({(m.size, m.scale) for m in models}) == 1
    grids = np.stack([m.params(a, b) for m, a, b in zip(models, x, y)])
    image, q = piffutils.draw_inputs(grids, models[0].scale, kw["stamp_size"],
                                     kw["oversamp"], None, dev)
    # the interpolation's least work: the padded grids, the query axes and
    # the stamps once; the row contraction and the column contraction
    S, ny, nx = image.shape
    ns, taps = q.shape[1], TAPS["D5512"]
    interp_bound = bound(8 * (image.numel() + 2 * q.numel() + S * ns * ns),
                         2 * S * ns * taps * nx + 2 * S * ns * ns * taps)

    draw = times["psf.draw"]
    rec = {"phase": "piff_block", "piff_files": n_files, "inpsf": over["INPSF"],
           "stamps": len(blk.stamp_stats), "first_block_s": t_first,
           "first_launches": first_launches, "block_s": t_block,
           "blocks_per_hour": 3600.0 / t_block, "SL1": SL1, "uc_median": uc_med,
           "minus_bench": {"block_s": t_block - bench["block_s"], "SL1": SL1 - bench["SL1"],
                           "uc_median": uc_med - bench["uc_median"]},
           "inputs_s": times["block.inputs"]["host_s"],
           "sample_group_s": times["psf.sample_group"]["host_s"],
           "draws": {"calls": draw["calls"], "host_s": draw["host_s"],
                     "event_ms": draw["device_ms"],
                     "group_stamps": len(models), "stamp": list(card[0].shape),
                     "grid": list(image.shape),
                     "interp_device_ms": median_ms(torch, lambda: grid_interp(image, q, q), 20),
                     "interp_bound_ms": interp_bound[0], "interp_bound_by": interp_bound[1],
                     "interp_trace": trace_kernels(torch, lambda: grid_interp(image, q, q), 6),
                     "batched_s": host_median_s(lambda: piffutils.draw_models(models, x, y, **kw)),
                     "single_s": host_median_s(lambda: [m.draw(a, b, **kw) for m, a, b
                                                        in zip(models, x, y)]),
                     "card_vs_cpu_max_abs": err, "float32_spacing": spacing},
           "launches": launches, "phases": times}
    emit(rec)
    assert len(blk.stamp_stats) == 16, blk.stamp_stats
    assert abs(SL1 - 1.0) < SL1_TOL and uc_med < UC_MAX, (SL1, uc_med)
    assert draw["calls"] == times["psf.sample_group"]["calls"] > 0, rec["draws"]
    assert err <= spacing, rec["draws"]
    del image, q
    k1 = k1_main_path(torch, dev, "piff/psf_sampling", k1_caps.pop("piff/psf_sampling"),
                      floor_ms, parent)
    emit({"phase": "k1_main_path", "criterion": TOL, **k1})
    k2 = k2_main_path(torch, dev, "piff_group_1", plan_cap.plan, floor_ms)
    del plan_cap.plan
    emit({"phase": "k2_main_path", "criterion": TOL, **k2})
    return launches, k1, k2


def phase_meta_shear(torch, dev, chain):
    """Metadetection on the chain's blocks and MultiInterp at production
    size (module docstring, 13b)."""
    from pyimcom_tpu_torch.config import Settings
    from pyimcom_tpu_torch.meta import ginterp
    from pyimcom_tpu_torch.meta.distortimage import MetaMosaic

    block = next(p for p in chain["coadd_block_s"] if p.endswith("_00_01.fits"))
    g1, g2 = META_SHEAR
    jac = np.array([[1 - g1, -g2], [-g2, 1 + g1]]) / np.sqrt(1 - g1 * g1 - g2 * g2)

    def shear(mm):
        t0 = time.perf_counter()
        res = mm.shearimage(mm.cfg.n1 * mm.cfg.n2, jac=jac, psfgrow=META_PSFGROW)
        return res, time.perf_counter() - t0

    def summary(res, secs):
        return {"s": secs, "UMAX": res["pars"]["UMAX"], "SMAX": res["pars"]["SMAX"],
                "masked_share": float(res["mask"].mean()), "image": list(res["image"].shape)}

    runs, example = {}, {}
    for route, device in (("card", dev), ("cpu", "cpu")):
        mm = MetaMosaic(block, device=device)
        mm.mask_fidelity_cut(40)
        runs[route] = shear(mm)
        mm.mask_noise_cut(-3)
        example[route] = shear(mm)
    card, cpu = runs["card"][0], runs["cpu"][0]
    scale = float(np.abs(cpu["image"]).max())
    err = float(np.abs(card["image"].astype(np.float64) - cpu["image"]).max())
    ex_card, ex_cpu = example["card"][0], example["cpu"][0]

    # production size: a seeded 3x3 mosaic of META_PROD^2 blocks, the same
    # shear and smoothing as shearimage gives the chain's mosaic
    cfg = mm.cfg
    sigma = cfg.sigmatarget * Settings.pixscale_native * (180.0 / np.pi) / cfg.dtheta
    dCov = sigma ** 2 * (META_PSFGROW ** 2 * jac @ jac.T - np.identity(2))
    N, rows, n_in = META_PROD, META_ROWS, 3 * META_PROD
    image = np.random.default_rng(PIFF_SEED).standard_normal((2, n_in, n_in), dtype=np.float32)
    in_mask = np.zeros((n_in, n_in), dtype=bool)
    origin = np.full(2, (n_in - 1) / 2.0) - jac @ np.array([(N - 1) / 2.0, (rows - 1) / 2.0])
    host_s, gather_events, gather_bytes, gather_flops = [], [], [], []
    interp_matrix, gather_taps = ginterp.InterpMatrix, ginterp.gather_taps

    def timed_matrix(*a, **k):
        t0 = time.perf_counter()
        out = interp_matrix(*a, **k)
        host_s.append(time.perf_counter() - t0)
        return out

    def timed_gather(img, msk, base, offsets, T, sub_mask):
        # the least bytes: T, the cells and edge flags read once, about one
        # reached mosaic pixel (all layers, and its mask) an output pixel,
        # the values and mask written once
        n, nl, es = len(base), img.shape[0], img.element_size()
        gather_bytes.append(T.nbytes + 8 * n + n + n * (nl * es + 1) + n * (nl * es + 1))
        gather_flops.append(2 * len(offsets) * n * nl)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = gather_taps(img, msk, base, offsets, T, sub_mask)
        e1.record()
        gather_events.append((e0, e1))
        return out

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ginterp.InterpMatrix, ginterp.gather_taps = timed_matrix, timed_gather
    try:
        with HostRSS() as rss, profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out, out_mask, Umax, Smax = ginterp.MultiInterp(
                image, in_mask, (rows, N), origin, jac, 6.0, sigma * np.sqrt(8 * np.log(2)),
                [dCov[0, 0], dCov[0, 1], dCov[1, 1]], device=dev)
            t_prod = time.perf_counter() - t0
    finally:
        ginterp.InterpMatrix, ginterp.gather_taps = interp_matrix, gather_taps
    trace = profile_rows(prof, top=6)
    gather_ms = [a.elapsed_time(b) for a, b in gather_events]
    gather_bound = bound(sum(gather_bytes), sum(gather_flops))
    rec = {"phase": "meta_shear", "block": Path(block).name, "shear": [g1, g2],
           "psfgrow": META_PSFGROW, "fidelity_cut": {"card": summary(*runs["card"]),
                                                     "cpu": summary(*runs["cpu"])},
           "card_vs_cpu_max_abs": err, "float32_spacing": float(np.spacing(np.float32(scale))),
           "example_cuts": {"card": summary(*example["card"]), "cpu": summary(*example["cpu"]),
                            "card_vs_cpu_max_abs": float(np.abs(
                                ex_card["image"].astype(np.float64) - ex_cpu["image"]).max())},
           "production": {"mosaic": [2, n_in, n_in], "out": [rows, N], "s": t_prod,
                          "blocks": len(host_s), "interp_matrix_host_s": sum(host_s),
                          "interp_matrix_host_s_each": host_s,
                          "gather_event_ms": sum(gather_ms), "gather_event_ms_each": gather_ms,
                          "gather_bound_ms": gather_bound[0], "gather_bound_by": gather_bound[1],
                          "trace": trace, "Umax": Umax, "Smax": Smax,
                          "masked_share": float(out_mask.mean()),
                          "finite": bool(np.all(np.isfinite(out))),
                          "max_memory_allocated_GiB": torch.cuda.max_memory_allocated(dev)
                          / 2 ** 30,
                          "host_rss_GiB": [rss.start_GiB, rss.peak_GiB]}}
    emit(rec)
    assert err <= 2 * rec["float32_spacing"] and scale > 0, rec
    assert np.array_equal(card["mask"], cpu["mask"]) and not card["mask"].all(), rec
    assert np.array_equal(ex_card["mask"], ex_cpu["mask"]), rec
    assert rec["example_cuts"]["card_vs_cpu_max_abs"] <= 2 * rec["float32_spacing"], rec
    assert len(host_s) == len(gather_ms) == -(-rows * N // 393216), rec["production"]
    assert rec["production"]["finite"] and rec["production"]["masked_share"] < 0.05, rec
    return rec


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


def main(argv=None):
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="smoke run of pyimcom_tpu_torch on one GPU")
    ap.add_argument("--legendre-order", type=int, default=None,
                    help="only measure config 3's Legendre conversion and split at this "
                         "order (legendre_cost)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(REPO), str(REPO / "tests")]
    dev = torch.device("cuda", 0)
    smi = gpu_name_and_power()
    if args.legendre_order is not None:
        shutil.rmtree(WORK / "legendre_cost", ignore_errors=True)
        legendre_cost(torch, dev, args.legendre_order)
        print(smi, flush=True)
        return 0

    # ---- 1. device and build ------------------------------------------------
    from concurrent.futures import ThreadPoolExecutor

    from pyimcom_tpu_torch import _build

    t0 = time.perf_counter()
    jobs = {"interp_d5512": lambda: _build.build("interp_d5512"),
            "bilinear": lambda: _build.build("bilinear")}
    for name in PARENTS:
        if parent_src(name).exists():
            jobs[f"{name}_parent"] = lambda name=name: build_parent(name)
    with ThreadPoolExecutor(len(jobs)) as pool:
        reports = {k: f.result() for k, f in
                   {k: pool.submit(job) for k, job in jobs.items()}.items()}
    _build.library("interp_d5512")
    _build.library("bilinear")
    parent, parent_k4 = parent_entry("interp_d5512"), parent_entry("bilinear")
    k4_build = {"ptxas": {k: v for k, v in ptxas_entries(reports["bilinear"]).items()
                          if "adjoint" in k},
                "sass_atomics": sass_atomics(_build.library_path("bilinear"), "adjoint")}
    emit({"phase": "build", "gpu": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": time.perf_counter() - t0,
          "ptxas": {k: [ln.strip() for ln in r.splitlines()
                        if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
                    for k, r in reports.items()}, "K4": k4_build})

    # ---- 2. the probe entry point ---------------------------------------------
    from pyimcom_tpu_torch import probe

    probe.reset_launch_counts()
    verdict = probe.run()
    probe_launches = probe.launches["probe_add_one"]
    emit({"phase": "probe", **verdict, "launches": probe_launches})
    assert verdict["ok"] and probe_launches > 0, verdict

    # ---- 3. kernels vs plain versions -----------------------------------------
    kern = phase_kernels(torch, dev, parent)
    floor_ms = kern["launch_floor_ms"]
    emit({"phase": "kernels", "criterion": TOL, **kern})

    # ---- 4. the bench block ---------------------------------------------------
    from survey_fixture_torch import build_survey

    from pyimcom_tpu_torch.bench import quality_check
    from pyimcom_tpu_torch.fitsio import fits_read

    shutil.rmtree(WORK, ignore_errors=True)
    cfg_dict = build_survey(WORK, n_obs=8, extrainput=["cstar14"])
    k1_caps = {}
    with capture_k1("bench_cold", ["star_injection"], k1_caps):
        blk_cold, _out, t_cold, cold_launches = run_block(cfg_dict, "_cold")
    with capture_first_plan() as bench_cap, capture_k1("bench", ["psf_sampling"], k1_caps):
        blk, out, t_block, launches = run_block(cfg_dict, "_bench")
    SL1, uc_med = quality_check(out)
    emit({"phase": "bench_block", "stamps": len(blk.stamp_stats),
          "block_s": t_block, "blocks_per_hour": 3600.0 / t_block,
          "cold_block_s": t_cold, "cold_inputs_s": blk_cold.phase_times()["block.inputs"]["host_s"],
          "cold_launches": cold_launches,
          "SL1": SL1, "uc_median": uc_med,
          "SL1_minus_cpu_record": SL1 - CPU_RECORD["SL1"],
          "uc_median_over_cpu_record": uc_med / CPU_RECORD["uc_median"],
          "launches": launches, "phases": phase_times(blk)})
    assert len(blk.stamp_stats) == 16, blk.stamp_stats
    assert abs(SL1 - 1.0) < SL1_TOL, SL1
    assert uc_med < UC_MAX, uc_med

    # ---- the bench entry's line, from its warm bench block ----------------------
    from pyimcom_tpu_torch import bench
    from pyimcom_tpu_torch.ops import interp_cuda

    interp_cuda.reset_launch_counts()
    bench_line, bblk, SL1_b, uc_b = bench.bench_block(
        dict(cfg_dict, OUT=cfg_dict["OUT"] + "_entry"), "cuda", stop=0, warmup=False)
    bench_launches = dict(interp_cuda.launches)
    emit({"phase": "bench_line", "stamps": len(bblk.stamp_stats), "SL1": SL1_b,
          "uc_median": uc_b, "launches": bench_launches, "line": bench_line})
    print(json.dumps(bench_line), flush=True)
    assert len(bblk.stamp_stats) == 16
    assert all(bench_launches[k] > 0 for k in family_kernels("D5512")), bench_launches
    assert abs(SL1_b - 1.0) < SL1_TOL and uc_b < UC_MAX, bench_line
    del bblk

    # ---- checkpoint: killed after 2 snapshots, resumed in a fresh process -----
    phase_checkpoint(cfg_dict, out)

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
    variants["iternqc"] = dict(variants["iter"], EMPIRNQC=True)
    variants["empirnqc"] = dict(variants["empir"], EMPIRNQC=True)
    img, cube, solve_ms, cross_launches, cross_out = {}, {}, {}, {}, {}
    for name, over in variants.items():
        blk_v, cross_out[name], _t, cross_launches[name] = run_block(
            cfg_dict, "_x" + name, no_system=name == "empirnqc", STOP=2, **over)
        out_v = cross_out[name]
        cube[name] = np.asarray(fits_read(out_v)[0].data, np.float64)
        img[name] = cube[name][0, 0][STAR_REGION]
        solve_ms[name] = solve_ms_per_stamp(blk_v)

    def diff(a, b):
        d = img[a] - img[b]
        return {"std": float(np.std(d)), "mean": float(np.mean(d))}

    cross = {f"{a}-{b}": diff(a, b) for a, b in
             (("chol", "multik"), ("multik", "eigen"), ("chol", "iter"), ("eigen", "iter"),
              ("chol", "empir"), ("eigen", "empir"))}
    signal_std = float(np.std(img["chol"]))
    # without quality control the science cube is the same solve: Iterative
    # everywhere, Empirical where its weights are finite
    fin = np.isfinite(cube["empirnqc"])
    nqc = {"iternqc-iter": float(np.abs(cube["iternqc"] - cube["iter"]).max()
                                 / np.abs(cube["iter"]).max()),
           "empirnqc-empir": float(np.abs(cube["empirnqc"] - cube["empir"])[fin].max()
                                   / np.abs(cube["empir"][fin]).max()),
           "empirnqc_finite_share": float(fin.mean())}
    emit({"phase": "solver_cross", "stop": 2, "region": "[0:25, 25:50]", "diff": cross,
          "signal_std": signal_std, "no_quality_control": nqc, "solve_ms_per_stamp": solve_ms,
          "launches": cross_launches})
    for pair in ("chol-multik", "multik-eigen"):
        assert cross[pair]["std"] < 3e-5 and abs(cross[pair]["mean"]) < 2e-6, (pair, cross)
    assert cross["chol-iter"]["std"] < 2.5e-3, cross
    assert cross["chol-empir"]["std"] < 1.05 * signal_std, cross
    assert all(np.all(np.isfinite(v)) for k, v in img.items() if k != "empirnqc")
    assert nqc["iternqc-iter"] < TOL and nqc["empirnqc-empir"] < TOL, nqc

    # ---- the runner's command line: a block, its rerun, a mosaic over 2 workers
    phase_runner(cfg_dict, out, cross_out["chol"])

    # ---- 7. production geometry: one 2x2 group, three solvers -----------------
    with capture_first_plan() as prod_cap, capture_k1("production", ["psf_sampling"], k1_caps):
        prod_f64 = run_production(torch, dev, cfg_dict, "production_group", "_prod")
    phase_production_mixed(torch, dev, cfg_dict, prod_f64)
    run_production(torch, dev, cfg_dict, "production_iterative", "_prodit",
                   LAKERNEL="Iterative", KAPPAC=[0.0], ITERRTOL=0.0015, ITERMAX=30)
    run_production(torch, dev, cfg_dict, "production_eigen", "_prodeig",
                   LAKERNEL="Eigen", KAPPAC=MULTI_KAPPA)

    # ---- two production rows: retained pools, then a third of them ------------
    phase_pool_budget(torch, dev, cfg_dict)

    # ---- 8. K2 at the main path's own shapes ----------------------------------
    main_k2 = [k2_main_path(torch, dev, "bench_group_1", bench_cap.plan, floor_ms),
               k2_main_path(torch, dev, "production_group", prod_cap.plan, floor_ms)]
    del bench_cap.plan, prod_cap.plan
    for rec in main_k2:
        emit({"phase": "k2_main_path", "criterion": TOL, **rec})

    # ---- 9. galaxy injection: gsext14 at STOP 4, cold then warm ----------------
    (WORK / "cache_gal").mkdir()
    gal = dict(EXTRAINPUT=[GALAXY], STOP=4,
               INLAYERCACHE=str(WORK / "cache_gal" / "in"))
    with capture_k1("galaxy", ["galaxy_injection"], k1_caps):
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

    # ---- 10. K1 at the main path's own launches -------------------------------
    want = {"bench_cold/star_injection", "bench/psf_sampling", "production/psf_sampling",
            "galaxy/galaxy_injection"}
    assert set(k1_caps) == want, sorted(k1_caps)
    main_k1 = {}
    for key in sorted(want):
        main_k1[key] = k1_main_path(torch, dev, key, k1_caps.pop(key), floor_ms, parent)
        emit({"phase": "k1_main_path", "criterion": TOL, **main_k1[key]})

    # ---- 11. G4460: the bench block, the split-PSF loop, the full canvas ----
    g4460_plan, g4460_launches = phase_g4460_block(cfg_dict, k1_caps)
    task_launches, split_launches, split_k1, split_k2, loop = phase_psfsplit_loop(
        torch, dev, k1_caps, floor_ms, parent)
    torch.cuda.empty_cache()
    phase_fftconv_full(torch, dev, loop)
    torch.cuda.empty_cache()
    g_k1, g_k2 = phase_g4460_kernels(torch, dev, k1_caps, g4460_plan, floor_ms)
    del g4460_plan
    assert not k1_caps, sorted(k1_caps)

    # ---- 11b. Piff PSF files drawn on the card --------------------------------
    piff_launches, piff_k1, piff_k2 = phase_piff_block(
        torch, dev, cfg_dict, {"block_s": t_block, "SL1": SL1, "uc_median": uc_med},
        floor_ms, parent)
    torch.cuda.empty_cache()

    # ---- 12. destriping, from imdestripe.main to the coadd ------------------------
    k3, k4, ds_launches = phase_destripe(torch, dev, floor_ms, parent_k4, k4_build)
    torch.cuda.empty_cache()

    # ---- 13. the chained 2x2 mosaic, from destripe to compression -----------
    chain = phase_mosaic_chain()

    # ---- 13b. metadetection on the chain's blocks, and at production size ----
    phase_meta_shear(torch, dev, chain)

    # ---- summary ---------------------------------------------------------------
    # the kernels line's bound is bytes and operations alone (roofline_ms);
    # its K1 and K2 times are those of the main path's own launches, its
    # D5512 launches those of the bench block, the Piff block and the
    # split-PSF loop's iteration-0 block, whose errors are those of every
    # captured D5512 launch, theirs too
    src = "pyimcom_tpu_torch/csrc/interp_d5512.cu"
    no_lib = None           # no PyTorch call computes D5512 or G4460 interpolation

    def line(name, source, replaces, n, err, rec, library_ms):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n, "max_abs_err": err, "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["roofline_ms"],
                "bound_by": rec["roofline_by"], "library_ms": library_ms,
                "launch_floor_ms": floor_ms}

    k1 = main_k1["bench/psf_sampling"]
    k1_errs = ([kern["K1"]["max_abs_err"], piff_k1["max_abs_err"], split_k1["max_abs_err"]]
               + [r["max_abs_err"] for r in main_k1.values()])
    d5512 = [launches, piff_launches, split_launches]
    summary = [line("interp_d5512_dense", src, "pyimcom_tpu/ops/interp_pallas.py:85",
                    sum(n["interp_d5512_dense"] for n in d5512), max(k1_errs), k1, no_lib)]
    k2 = {one["mode"]: one for one in main_k2[0]["launches"]}
    for mode, key in (("pool", "K2_pool"), ("B", "K2_B")):
        errs = [kern[key]["max_abs_err"]] + [one["max_abs_err"]
                                              for rec in main_k2 + [piff_k2, split_k2]
                                              for one in rec["launches"] if one["mode"] == mode]
        summary.append(line(f"sweep_d5512_scatter.{mode}", src,
                            "pyimcom_tpu/ops/interp_pallas.py:140",
                            sum(n[f"sweep_d5512_scatter.{mode}"] for n in d5512),
                            max(errs), k2[mode], no_lib))
    # the G4460 forms: launches of the G4460 bench block and the wing
    # subtraction task; K1's time is the G4460 block's PSF sampling, K2's
    # its first group's
    summary.append(line("interp_g4460_dense", src, "pyimcom_tpu/ops/interp.py:357",
                        g4460_launches["interp_g4460_dense"]
                        + task_launches["interp_g4460_dense"],
                        max(r["max_abs_err"] for r in g_k1.values()),
                        g_k1["g4460/psf_sampling"], no_lib))
    k2g = {one["mode"]: one for one in g_k2["launches"]}
    for mode in ("pool", "B"):
        summary.append(line(f"sweep_g4460_scatter.{mode}", src,
                            "pyimcom_tpu/ops/interp.py:386",
                            g4460_launches[f"sweep_g4460_scatter.{mode}"],
                            max(one["max_abs_err"] for one in g_k2["launches"]
                                if one["mode"] == mode), k2g[mode], no_lib))
    bil = "pyimcom_tpu_torch/csrc/bilinear.cu"
    summary.append(line("bilinear_gather", bil, "pyimcom_tpu/ops/bilinear.py:45",
                        ds_launches["bilinear_gather"], k3["max_abs_err"], k3, k3["library_ms"]))
    summary.append(line("bilinear_scatter_adjoint", bil, "pyimcom_tpu/ops/bilinear.py:61",
                        ds_launches["bilinear_scatter_adjoint"], k4["max_abs_err"], k4,
                        k4["library_ms"]))
    summary.append(line("probe_add_one", "pyimcom_tpu_torch/csrc/probe.cu",
                        "scripts/probe_pallas.py:33", probe_launches,
                        kern["probe"]["max_abs_err"], kern["probe"],
                        kern["probe"]["library_ms"]))
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
