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
   with a 9-argument C entry, bilinear.cu of commit c560e0f, the
   one-thread-a-query K4 with a 9-argument C entry, and, as
   interp_d5512_pr12.cu, interp_d5512.cu of commit 910c170, whose K2 entries
   take today's arguments), started together, with
   their ptxas register and spill lines and the atomic instructions in K4's
   SASS (cuobjdump; none of f64 in the planned body); and, as
   bilinear_tiled.cu, bilinear.cu of commit 28a3190 (the tiled K4 body with
   its 11-argument entries, both position forms); and, as
   bilinear_plan.cu, bilinear.cu of commit 379dcb5 (K4's plan kernel in two
   C entries with host read-backs between and after them, both forms);
2. probe: the probe entry point builds csrc/probe.cu and launches its
   kernel on an (8, 128) float32 tensor (its own path: counts reset before,
   read after);
3. kernels: the card's launch floor (the device time of an empty kernel,
   torch.cuda._sleep(0)); each kernel against its plain PyTorch version on
   the card, on seeded random inputs at its path's shapes (criterion: 1e-12
   of scale in f64, exact for the probe), with the device times of both
   and the kernel's bounds, K2 also beside K2 of commit 910c170 where
   built; the sleep check of the timing on K1 and the probe (below);
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
   then multi_device: the bench block with its groups over every card
   present, or over ``["cuda:0"] * 2`` (two bands on the one card) where
   there is one -- Block(devices=...), the banded rounds of
   parallel/mesh.py -- held to the warm one-device block (1e-12 of scale,
   maps 1 LSB) with no cross-device pool reuse: its seconds, the devices,
   the round statistics, the seams recomputed and the launches;
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
   production group (captured while those blocks ran), and K2<8> on the
   production group's rows launched as G4460 (its production shape; no
   G4460 production block runs): every launch of each group timed alone and
   summed, against its plain version (1e-12 of scale), with its bounds and
   the tiles it took from L2, and, where built, K2 of commit 910c170 on the
   same launches (held to the same criterion, timed in turns with the
   kernel);
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
   scale), with their bounds, and K2 of commit 910c170 on the same launches
   where built; wing_canvas_production: K1<8>'s wing-canvas launches at
   production size made on the card (wing_queries: a WING_A^2 canvas at
   oversampling 3 mapped into mosaic blocks of 2560^2 padded to 2572^2,
   seeded images from a torch.Generator): one production block at rolls
   0, 45 and 90 degrees, the 25-36 launches of a layer at 0 degrees and
   one block covering the canvas (WING_A^2 queries, a 1.07 GB image), each
   through interp2d_dense with its canvas hint (the canvas body), timed in
   turns with the body of runs of 32 queries, the two equal bit for bit
   on the whole launch, the canvas body within 1e-12 of scale of the plain
   version on its first 2^22 queries, with the bytes bound and the
   shared-memory bound (64 patch reads of 8 bytes a query on the grid at
   128 bytes a clock an SM, at the card's top SM clock), and on the
   covering launch the runs body's time on x, y and the result alone
   (every query moved off the grid);
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
   k2_main_path) against their plain versions (1e-12 of scale); K2<8>
   where the PSFs are oversampled 8x: that group's rows launched as G4460,
   and the first group of a G4460 production group (PROD geometry, INPSF
   [dir, "piff", 8]: SL1 not held, 4 finite stamps), captured, each held
   to its plain version (run once, not timed); each K2 record beside K2 of
   commit 910c170 where built;
12. destripe (in .smoke_work/destripe/): build_survey(n_obs=6) less its
   fourth F184 exposure -- 3 F184 SCAs at 4088^2 overlapping in 6 ordered
   pairs (the host builds ~10 s of pair map a pair) -- with row stripes
   injected as scripts/run_chained_pipeline.py does, then
   ``pyimcom_tpu_torch.imdestripe.main(cfg, maxiter=5)`` on the card (object
   mask and WCS gain on): the host map build and upload seconds, peak device
   memory, seconds per CG iteration, the cost before and after, the K3 / K4
   launches and the plan kernel's (one a pair), K4's launches by route and
   its tiles off the planned route (none), one cost-and-gradient's
   device time and its kernels by name from one torch.profiler trace; the
   kernel route of the
   cost against its plain route (autograd through the plain gather) at zero
   and random parameters (cost to rtol 1e-12, gradient to rtol 1e-9 and atol
   1e-12); at least half of the SCAs destriped by 2x in their row medians
   against the clean files (tests/test_full_pipeline.py); then K3 and K4
   alone on the first pair (against their plain versions, their bounds,
   grid_sample and its input gradient as the library yardstick, and the
   earlier revisions' K4 where built, timed in turns with it; K4's plan --
   r, bytes, the plan kernel's build ms beside its plain version's and,
   where built, commit 379dcb5's plan kernel's in turns, the plan held to
   both word for word --, two launches bit for bit,
   its registers and its tiles off the plan against predict_off_plan_tiles;
   the off-plan body once on the library's work, a 1-D stream, against the
   plain version, its tiles off the plan as predicted; what the plans cost
   and save on the main path's K4 work, plan_economy); k4_synthetic: K4
   on a synthetic 4088^2 pair rolled by 0 and 45 degrees (k4_variants.py's
   inputs), both position forms, against its plain version, itself and,
   where built, commit 28a3190's body, in turns; K4 on the same pixels
   shrunk 0.1x, both forms, whose plan overflows the plan kernel's ring
   (without a plan and over it: the off-plan body, its tiles off the plan
   as predicted, against the plain version, timed beside the planned body
   at 0 degrees), and a DestripeCost holding that map among ordinary ones
   (one plan read-back at its build, none in a gradient; value_and_grad
   against its plain route); X7, wcsutil.stg_projection_torch, on the
   grid's 4088^2 points on the card against the CPU (x7); and the
   bench block coadded from the clean, striped and destriped inputs (each
   with its own input directory and layer cache): 16 stamps, finite maps,
   U/C medians equal to 1e-6, the destriped science nearer the clean one
   than the striped, by RMS, and the SL1 of all three;
12b. destripe_storage: the same 6 pair maps (no new map build) in three
   DestripeCosts -- float64 maps on the card, float32 maps on the card, and
   float32 maps in memory-mapped files streamed pair by pair from their
   pageable pages (map_store="host", the maps as
   DestripeProblem(map_dtype="f32", memmap=True) hands them over, written
   with imdestripe.to_memmap) -- each with its build seconds, peak and resident
   device memory, one cost-and-gradient's host seconds and device time
   and its launches by form (the f32 routes launch K3 / K4's float32
   forms), the two float32 routes held to the float64 one on the same
   positions (the float32 maps widened, exactly: cost to rtol 1e-12,
   gradient to rtol 1e-9 and atol 1e-12), the streamed route's peak at
   least four pairs of float32 maps under the on-card one's, what rounding
   the maps to float32 changes (positions, cost, gradient), and how many
   4088^2 SCAs and pairs each route fits on the card, reckoned from those
   peaks; then K3 and K4's float32 forms alone on the first pair against
   their plain versions (1e-12 of scale), their float64 forms on the
   widened positions and grid_sample, with their bounds (8 bytes of
   positions a query, not 16), K4's f32 form beside commit 28a3190's where
   built, its plan and its repeats bit for bit; each route's K4 launches
   by route and tiles off the plan (none);
13. mosaic_chain (in .smoke_work/mosaic_chain/): ``pyimcom_tpu_torch.pipeline``
   as scripts/run_chained_pipeline.py's defaults run it, except --n-obs 6
   (4 F184 SCAs, 12 ordered pairs): a 2x2 mosaic of 8 x 8 stamps of 32
   px at 0.0390625", NPIXPSF 48, INPAD 1.055, PAD 1 on every side, cstar14
   and whitenoise1, through destripe (5 CG iterations), the layer caches
   (a forkserver pool), the four blocks, the halo exchange and compression:
   the seconds of every stage and the launches of K1-K4 in each (K3 and K4
   in destripe, K1 in layers, K1 and K2 in the coadd; the layer builds'
   K1 launches are counted in the pool's workers), K4's tiles off the
   planned route (none); at least half of the
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

``python3 chip_smoke.py --multi-device`` runs only the bench block over
every card (multi_device) and multi_device_production_row: a production
row of 8 groups (STOP 32) on one card and over every card's band, for a
machine with several cards.

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
# whose entries parent_entry() binds
PARENTS = {
    "interp_d5512": ("7671040", "8aaf4ea17e3cd5b6b57ddceda891cd142db8ba5ba2f67bf43b7736a0bec0eeef",
                     ("interp_d5512_dense",)),
    "bilinear": ("c560e0f", "aa9d46b1a6683c0509634b51bdac866b6d80cef0b8af2a27853d0ed8f6323330",
                 ("bilinear_scatter_adjoint",)),
    # K2 of commit 910c170: a block a pool tile or a B i1, with the C entry of
    # today's K2 (a B tile must hold one i1: per_i1_tiles)
    "interp_d5512_pr12": ("910c170",
                          "25f3e11095a956b03d0a4d5981a1cf7be9b352b8bbb7152030364055459c3fa8",
                          ("sweep_d5512_scatter", "sweep_g4460_scatter")),
    # K4 of commit 28a3190 (the tiled body: shared-memory boxes flushed with f64
    # atomics into an output the caller zeroes), both position forms
    "bilinear_tiled": ("28a3190",
                      "55eb7ac10a8b81e32cbea6ea1f437220d6eac1f364890a34ea38f7e9f249fb66",
                      ("bilinear_scatter_adjoint", "bilinear_scatter_adjoint_f32")),
    # K4's plan kernel of commit 379dcb5: a rows pass, a read-back of the most
    # bands of a tile, a columns pass and a read-back of the counts, both
    # position forms
    "bilinear_plan": ("379dcb5",
                      "f7e7fc06358d6e3c1682b8bdcf8eb0142f146feaaca757b7d45b373c14ceed04",
                      ("bilinear_adjoint_plan_rows", "bilinear_adjoint_plan_rows_f32",
                       "bilinear_adjoint_plan_cols", "bilinear_adjoint_plan_cols_f32")),
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
              kern="D5512", segments=None):
    """K1 of family `kern` on one launch's inputs (on the card; `lattice_row`
    and the canvas hint `segments` as its caller passed them): its device
    time, its runs of 32 queries, its error against the plain version, the
    plain version's time, the bounds (images, x, y and the result once;
    QUERY_FLOP a query on the grid), and the earlier revision's K1 (D5512)
    on the same inputs where built; with a canvas hint also the body that
    takes runs of 32 queries on the same launch (`runs_ms`, in turns with
    the canvas body; the two held equal bit for bit)."""
    from pyimcom_tpu_torch.ops import interp_cuda as ic
    from pyimcom_tpu_torch.ops.interp import KERNEL_FAMILIES

    lo, hi = KERNEL_FAMILIES[kern][3:]
    R, ny, nx = images.shape
    Nq = x.shape[1]
    fx, fy = torch.floor(x), torch.floor(y)
    on = int(((fx >= lo) & (fx < nx - hi) & (fy >= lo) & (fy < ny - hi)).sum())
    got = ic.interp_dense(images, x, y, kern, lattice_row=lattice_row, segments=segments)
    want = ic.interp_dense_plain(images, x, y, kern)
    torch.cuda.synchronize()
    runs = (R * -(-lattice_row // 8) * -(-(Nq // lattice_row) // 4) if lattice_row
            else R * -(-Nq // 32))
    extra = {}
    if segments is not None:
        t = in_turns(torch, {
            "canvas": lambda: ic.interp_dense(images, x, y, kern, segments=segments),
            "runs": lambda: ic.interp_dense(images, x, y, kern)}, reps)
        extra = dict(canvas_tiles=len(segments.tiles), segments=len(segments.segments),
                     bit_identical_to_runs=bool(torch.equal(got, ic.interp_dense(
                         images, x, y, kern))), ms=t["canvas"], runs_ms=t["runs"])
        assert extra["bit_identical_to_runs"], extra
    rec = dict(kern=kern, R=R, Nq=Nq, image=[ny, nx], lattice_row=lattice_row, on_grid=on,
               runs=runs, max_abs_err=rel_err(torch, got, want),
               ms=median_ms(torch, lambda: ic.interp_dense(
                   images, x, y, kern, lattice_row=lattice_row), reps),
               plain_ms=median_ms(torch, lambda: ic.interp_dense_plain(images, x, y, kern), 3),
               **bounds(8 * (images.numel() + 3 * x.numel()), QUERY_FLOP[kern] * on, floor_ms),
               launch_floor_ms=floor_ms)
    rec.update(extra)
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


def phase_kernels(torch, dev, parent, parent_k2=None):
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
             1: (ks, im_b, bmeta, ic.sweep_tiles(im_b, 1, xt_np, yt_np, n2f,
                                                 min_tiles=ic.b_min_tiles(dev)))}
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
        if parent_k2 is not None:
            out[name].update(beside_parent(torch, dev, parent_k2["D5512"], dst_k, dst_p, args,
                                           "D5512"))
    for name, rec in out.items():
        if name != "launch_floor_ms":
            assert rec["max_abs_err"] < TOL, (name, rec)
            assert rec.get("parent_max_abs_err", 0.0) < TOL, (name, rec)

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


def parent_entry(name, entry):
    """Entry `entry` of the earlier revision `name`, loaded with ctypes
    (build_parent() checked the source), or None where PARENT_DIR does not
    hold it: K1 of commit 7671040 (one thread a query, each patch read from
    L1 / L2) and K4 of commit c560e0f (one thread a query, four f64
    atomicAdds into device memory), both with 9 arguments, K2 of commit
    910c170 (both families), with today's 22 arguments, and K4 of commit
    28a3190 (the tiled body, both position forms), with 11."""
    import ctypes

    from pyimcom_tpu_torch.ops import interp_cuda

    if not parent_src(name).exists():
        return None
    if entry not in PARENTS[name][2]:
        raise ValueError(f"{entry} is not an entry of {name}'s parent")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # the tiled body's entries (both forms) take the query grid, not a count
    tiled = (p, p, i, i, p, p, i, i, p, p, p)
    plan_rows = (p, p, i, i, i, i, p, p, p, p, p)
    plan_cols = (p, p, i, i, i, i, p, p, i, p, p, p, p)
    argtypes = {("interp_d5512", "interp_d5512_dense"): (p, i, i, i, p, p, ll, p, p),
                ("bilinear", "bilinear_scatter_adjoint"): (p, p, i, i, p, p, ll, p, p),
                ("interp_d5512_pr12", "sweep_d5512_scatter"): interp_cuda._K2_ARGS,
                ("interp_d5512_pr12", "sweep_g4460_scatter"): interp_cuda._K2_ARGS,
                ("bilinear_tiled", "bilinear_scatter_adjoint"): tiled,
                ("bilinear_tiled", "bilinear_scatter_adjoint_f32"): tiled,
                **{("bilinear_plan", f"bilinear_adjoint_plan_{k}{sfx}"): a
                   for k, a in (("rows", plan_rows), ("cols", plan_cols))
                   for sfx in ("", "_f32")}}
    fn = getattr(ctypes.CDLL(str(parent_src(name).with_name(f"lib{name}_parent.so"))), entry)
    fn.argtypes = argtypes[name, entry]
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


def clip_segments(hint, n):
    """K1's canvas hint (interp_cuda.CanvasSegments) of the first `n` of its
    queries, or None without one."""
    from pyimcom_tpu_torch.ops import interp_cuda

    if hint is None:
        return None
    seg = np.asarray(hint.segments, np.int64)
    seg = seg[seg[:, 2] < n].copy()
    seg[:, 3] = np.minimum(seg[:, 3], n - seg[:, 2])
    seg = seg.astype(np.int32)
    return interp_cuda.CanvasSegments(seg, interp_cuda.canvas_tiles(seg, hint.step),
                                      hint.transpose, hint.step)


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
                                          segments=clip_segments(kw.get("segments"), n),
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
           **k1_record(torch, dev, images, x, y, floor_ms, parent, lattice_row=n, kern=kern,
                       segments=cap.get("segments"))}
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


def per_i1_tiles(tiles, m):
    """B tiles of runs of i1 (sweep_tiles) as one tile an i1 over the whole
    lattice, the tiles of K2's B mode before runs (commit 910c170)."""
    nu = tiles[:, 3].astype(np.int64)
    r = np.repeat(np.arange(len(tiles)), nu)
    u = tiles[r, 1] + np.arange(len(r)) - np.repeat(np.cumsum(nu) - nu, nu)
    return np.stack([tiles[r, 0], u, np.zeros_like(u), np.ones_like(u),
                     np.full_like(u, m)], 1).astype(np.int32)


def beside_parent(torch, dev, fn, dst_k, dst_p, args, kern):
    """K2 of commit 910c170 (`fn`, its entry of family `kern`) on the
    launch sweep_scatter(dst_k, *args, kern=kern), whose plain result is
    `dst_p`: its error against that, and its time and the kernel's, timed
    in turns (parent, kernel, kernel, parent: `parent_ms` and `ms` are the
    medians of both turns).  Its B mode takes one i1 a tile (per_i1_tiles)."""
    from pyimcom_tpu_torch.ops import interp_cuda as ic

    combined, xt, yt, ks, imeta, dmeta, tiles, inv, off, mode, n_pad, n2f = args
    K, ny, nx = combined.shape
    if mode == 1:
        tiles = torch.as_tensor(per_i1_tiles(tiles.cpu().numpy(), n2f * n2f), device=dev)
    wmax = ic.b_window(n2f, inv, kern) if mode == 1 else 0
    l2 = torch.zeros(1, dtype=torch.int64, device=dev)

    def parent_call():
        err = fn(dst_k.data_ptr(), dst_k.shape[0], combined.data_ptr(), K, ny, nx,
                 xt.data_ptr(), yt.data_ptr(), xt.shape[0], ks.data_ptr(), imeta.data_ptr(),
                 dmeta.data_ptr(), tiles.data_ptr(), tiles.shape[0], float(inv), float(off),
                 mode, n_pad, n2f, wmax, l2.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
        assert err == 0, err

    def kernel_call():
        ic.sweep_scatter(dst_k, *args, kern=kern)

    dst_k.zero_()
    parent_call()
    torch.cuda.synchronize()
    out = {"parent_max_abs_err": rel_err(torch, dst_k, dst_p),
           "parent_tiles": int(tiles.shape[0])}
    turns = [device_times(torch, f, 10, setup=dst_k.zero_)
             for f in (parent_call, kernel_call, kernel_call, parent_call)]
    out["parent_ms"] = statistics.median(turns[0] + turns[3])
    out["ms"] = statistics.median(turns[1] + turns[2])
    return out


def k2_main_path(torch, dev, name, cap, floor_ms, parent_k2=None, kern=None, time_plain=True):
    """Every K2 launch of one captured group, timed alone (median device
    time of 10 calls after 2 warm-ups), against its plain version, with its
    bounds and its L2-path tiles; `kern` launches the group's rows with
    another family than the block's (the pool tiles do not depend on it,
    the B windows follow b_window).  Where `parent_k2` (K2 of commit
    910c170) is built, it runs the same launches too, held to the same
    criterion, and its time is timed beside the kernel's in turns (parent,
    kernel, kernel, parent: `parent_ms` and `ms` are the medians of both
    turns).  With `time_plain` false the plain version runs once, for the
    check, and is not timed."""
    from pyimcom_tpu_torch.ops import interp_cuda as ic

    combined = torch.cat([s.to(dev) for s in cap["stacks"]])
    xt = torch.as_tensor(cap["xt"], device=dev)
    yt = torch.as_tensor(cap["yt"], device=dev)
    n2f, n_pad, inv, off = cap["n2f"], cap["n_pad"], cap["inv_scale"], cap["off_grid"]
    kern = kern or cap["kern"]
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
                   **k2_bound(mode, combined, xt, ks, imeta, dmeta, tiles, n2f, inv,
                              floor_ms, kern))
        assert one["max_abs_err"] < TOL, (name, one)
        if time_plain:
            one["plain_ms"] = median_ms(torch, lambda: ic.sweep_scatter_plain(dst_p, *args), 1,
                                        setup=dst_p.zero_)
        if parent_k2 is not None:
            one.update(beside_parent(torch, dev, parent_k2[kern], dst_k, dst_p, args[:-1], kern))
            assert one["parent_max_abs_err"] < TOL, (name, one)
        rec["launches"].append(one)
        del dst_k, dst_p
    for key in ("ms", "parent_ms", "plain_ms", "bound_ms", "roofline_ms"):
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


def same_plan(a, b):
    """Whether two K4 plans (bilinear_cuda.AdjointPlan, checked here) are
    word for word the same."""
    a.check(), b.check()
    return (all(getattr(a, k).equal(getattr(b, k)) for k in ("rows", "ptr", "spans"))
            and (a.pairs, a.window, a.over, a.shape, a.grid)
            == (b.pairs, b.window, b.over, b.shape, b.grid))


# the plan kernel of commit 379dcb5 where built: {position dtype: (its rows
# entry, its columns entry)}, set by main()
PARENT_PLAN = {}


def parent_plan(torch, fns, x, y, shape):
    """K4's plan of positions x, y (a 2-D grid) by the plan kernel of commit
    379dcb5 (`fns`: its rows and columns entries of their dtype), as that
    commit's build_adjoint_plan ran it: the rows entry, a read-back of the
    most bands of a tile, the columns entry and a read-back of the counts.
    Returns (rows, ptr, spans, incidences, window)."""
    rows_fn, cols_fn = fns
    dev, (ny, nx), (qny, qnx) = x.device, shape, x.shape
    T = -(-ny // 32) * -(-nx // 32)
    i32 = dict(dtype=torch.int32, device=dev)
    rows, ptr = torch.empty((T, 2), **i32), torch.empty(T + 1, **i32)
    meta = torch.empty(4, dtype=torch.int64, device=dev)
    scratch = torch.empty(2 * T, **i32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = rows_fn(x.data_ptr(), y.data_ptr(), qny, qnx, ny, nx, scratch.data_ptr(),
                  rows.data_ptr(), ptr.data_ptr(), meta.data_ptr(), stream)
    assert err == 0, err
    _pairs, nbt, bands, _window = meta.tolist()
    spans = torch.empty(bands, **i32)
    if nbt:
        scratch = torch.empty(2 * T * nbt, **i32)
        err = cols_fn(x.data_ptr(), y.data_ptr(), qny, qnx, ny, nx, rows.data_ptr(),
                      ptr.data_ptr(), nbt, scratch.data_ptr(), spans.data_ptr(),
                      meta.data_ptr(), stream)
        assert err == 0, err
    pairs, _nbt, _bands, window = meta.tolist()
    return rows, ptr, spans, pairs, window


def in_turns(torch, calls, reps):
    """Median device ms of each of `calls` ({name: fn}), timed in turns:
    reps // 2 calls of each in order, then as many in reverse order."""
    times = {k: [] for k in calls}
    for order in (list(calls), list(reversed(calls))):
        for k in order:
            times[k] += device_times(torch, calls[k], max(reps // 2, 1))
    return {k: statistics.median(ts) for k, ts in times.items()}


def k4_planned(torch, dev, v, x, y, gain, shape, plan, want, parents=None, reps=20):
    """K4 over `plan` on these inputs (a fresh output): its error against the
    plain result `want`, two launches bit for bit, its tiles off the plan
    (none, as predict_off_plan_tiles says), the plan's r, bytes, incidences,
    window and build ms (build_adjoint_plan on these positions: the plan
    kernel), `plan` held word for word to the plain builder's plan
    (`plan_equals_plain`) and that builder's ms on the card, and its
    device time, timed in turns with each earlier body in `parents` ({name:
    fn(out) that adds the adjoint into `out`}, run on a zero fill, which is
    timed with it; their errors as `<name>_max_abs_err`, times as
    `<name>_ms`)."""
    from pyimcom_tpu_torch.ops import bilinear_cuda as bc

    assert bc.plan_route(plan) == "planned", plan.over
    bc.reset_off_plan_tiles()
    got = bc.bilinear_scatter_adjoint(v, x, y, shape, gain, plan=plan)
    again = bc.bilinear_scatter_adjoint(v, x, y, shape, gain, plan=plan)
    torch.cuda.synchronize()
    rec = dict(max_abs_err=rel_err(torch, got, want),
               repeat_bit_identical=bool(torch.equal(got, again)),
               off_plan_tiles=bc.off_plan_tiles(dev),
               predicted_off_plan_tiles=bc.predict_off_plan_tiles(x, y, shape, plan),
               tile=[bc.PLAN_TILE, bc.PLAN_TILE], band_rows=bc.PLAN_BAND, plan_r=plan.r,
               plan_bytes=plan.nbytes, plan_pairs=plan.pairs, plan_window=plan.window,
               plan_build_plain_ms=median_ms(
                   torch, lambda: bc.build_adjoint_plan_plain(x, y, shape), 1),
               plan_equals_plain=same_plan(plan, bc.build_adjoint_plan_plain(x, y, shape)))
    # the plan kernel, beside commit 379dcb5's in turns where built (its
    # plan held to this one word for word)
    builds = {"plan_build": lambda: bc.build_adjoint_plan(x, y, shape)}
    if x.dtype in PARENT_PLAN:
        fns = PARENT_PLAN[x.dtype]
        old = parent_plan(torch, fns, x, y, shape)
        rec["plan_379dcb5_equal"] = (all(a.equal(b) for a, b in zip(
            old[:3], (plan.rows, plan.ptr, plan.spans))) and old[3:] == (plan.pairs, plan.window))
        builds["plan_build_379dcb5"] = lambda: parent_plan(torch, fns, x, y, shape)
    rec.update({f"{k}_ms": t for k, t in in_turns(torch, builds, 10).items()})
    del got, again
    calls = {"": lambda: bc.bilinear_scatter_adjoint(v, x, y, shape, gain, plan=plan)}
    out_p = torch.empty(shape, dtype=torch.float64, device=dev)
    for name, fn in (parents or {}).items():
        def call(fn=fn):
            out_p.zero_()
            fn(out_p)
        call()
        torch.cuda.synchronize()
        rec[f"{name}_max_abs_err"] = rel_err(torch, out_p, want)
        calls[name] = call
    for k, t in in_turns(torch, calls, reps).items():
        rec[f"{k}_ms" if k else "ms"] = t
    assert rec["max_abs_err"] < TOL and rec["repeat_bit_identical"], rec
    assert rec["plan_equals_plain"] and rec.get("plan_379dcb5_equal", True), rec
    assert rec["off_plan_tiles"] == rec["predicted_off_plan_tiles"] == 0, rec
    for name in parents or {}:
        assert rec[f"{name}_max_abs_err"] < TOL, (name, rec)
    return rec


def k4_stream(torch, dev, v, x, y, shape):
    """K4's off-plan body (the port's own tiled body, which a 1-D stream
    takes) once on these inputs, no gain: its error against the plain
    version, its launches by route, and its tiles off the plan (each tile of
    1 x 1024 queries holding one in bounds) against predict_off_plan_tiles."""
    from pyimcom_tpu_torch.ops import bilinear, bilinear_cuda as bc

    routes = dict(bc.adjoint_routes)
    bc.reset_off_plan_tiles()
    got = bc.bilinear_scatter_adjoint(v, x, y, shape)
    want = bilinear.bilinear_scatter_adjoint_plain(v, x, y, shape)
    torch.cuda.synchronize()
    rec = dict(stream_max_abs_err=rel_err(torch, got, want),
               stream_launches={k: bc.adjoint_routes[k] - routes[k] for k in routes},
               stream_off_plan_tiles=bc.off_plan_tiles(dev),
               stream_predicted_off_plan_tiles=bc.predict_off_plan_tiles(x, y, shape))
    assert rec["stream_max_abs_err"] < TOL, rec
    assert rec["stream_launches"] == {"planned": 0, "stream": 1}, rec
    assert rec["stream_off_plan_tiles"] == rec["stream_predicted_off_plan_tiles"] > 0, rec
    return rec


def plan_kernel_record(k4, x, floor_ms):
    """The plan kernel's record, from K4's record `k4` of the same positions
    `x` (k4_planned: the kernel's build ms, its plain version's, the plan
    held to it word for word): bounds of reading xf and yf once and writing
    the plan once (its integer work is a few operations a query)."""
    assert k4["plan_equals_plain"], k4
    return dict(ms=k4["plan_build_ms"], plain_ms=k4["plan_build_plain_ms"], max_abs_err=0.0,
                plan_379dcb5_ms=k4.get("plan_build_379dcb5_ms"),
                position_dtype=str(x.dtype).replace("torch.", ""), queries=x.numel(),
                plan_bytes=k4["plan_bytes"],
                **bounds(2 * x.element_size() * x.numel() + k4["plan_bytes"], 0, floor_ms))


def tiled_body(torch, dev, fn, v, x, y, gain, shape):
    """fn(out) running commit 28a3190's K4 entry `fn` (the tiled body, 11
    arguments) on these inputs, adding into `out`; None without it."""
    if fn is None:
        return None
    counter = torch.zeros(1, dtype=torch.int64, device=dev)
    qny, qnx = x.shape
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(out):
        err = fn(v.data_ptr(), None if gain is None else gain.data_ptr(), shape[0], shape[1],
                 x.data_ptr(), y.data_ptr(), qny, qnx, out.data_ptr(), counter.data_ptr(),
                 stream)
        assert err == 0, err
    return run


def bilinear_records(torch, dev, dc, floor_ms, parent_k4, k4_build, parent_tiled=None, reps=20):
    """K3 and K4 on the first pair of a DestripeCost `dc` (the neighbour's
    image and gain at the pair map's positions, on the target's pixel grid
    as the cost passes them, K4 over the cost's plan of the pair): device
    times, errors against the plain versions, bounds, and the library times
    of torch.nn.functional.grid_sample (bilinear, zeros, align_corners=True)
    and of its input gradient, which compute the unweighted gather and its
    adjoint where 0 <= floor(x) <= nx - 2 and 0 <= floor(y) <= ny - 2: they
    are timed on the pair's points inside that region (`library_points`),
    and so is each kernel doing the library's work there, without a gain and
    writing its result (`library_work_ms`; for K4 a 1-D stream, the
    off-plan body, first held to the plain version there: k4_stream).
    K3 runs as the main path runs it, adding into an accumulator; its bytes
    are x, y and the accumulator read and written (32 a query), the image and
    the gain once; K4's the values, x and y (24 a query), the plan, the gain
    once and the output written once.  Operations: GATHER_FLOP /
    ADJOINT_FLOP an in-bounds query.  K4 also gets k4_planned's record (its
    plan, repeats, tiles off the plan), its ptxas registers, spills and SASS
    atomics (`k4_build`), and, where built, the earlier revisions' times and
    errors on the same inputs, each timed with its output's zero fill, in
    turns with the new K4: commit c560e0f's (`parent_`) and commit
    28a3190's (`tiled_`, the tiled body).  Returns the K3 and K4 records and
    the plan kernel's (plan_kernel_record)."""
    import torch.nn.functional as F

    from pyimcom_tpu_torch.ops import bilinear, bilinear_cuda as bc

    _i, j = dc.pairs[0]
    img, gain, x, y, plan = dc.imgs[j], dc.ge[j], dc.xf[0], dc.yf[0], dc.plans[0]
    ny, nx = img.shape
    n, npix = x.numel(), ny * nx
    inb = bilinear.in_bounds(x, y, (ny, nx))
    n_in = int(inb.sum())
    v = torch.as_tensor(np.random.default_rng(20261017).normal(size=x.shape), device=dev)
    acc = torch.zeros(x.shape, dtype=torch.float64, device=dev)
    got3 = bc.bilinear_gather(img, x, y, gain, out=acc.clone())
    want3 = bilinear.bilinear_gather_plain(img, x, y, gain)
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
    parents = {}
    if parent_k4 is not None:
        stream = torch.cuda.current_stream(dev).cuda_stream

        def parent(out):
            err = parent_k4(v.data_ptr(), gain.data_ptr(), ny, nx, x.data_ptr(), y.data_ptr(),
                            n, out.data_ptr(), stream)
            assert err == 0, err
        parents["parent"] = parent
    if parent_tiled is not None:
        parents["tiled"] = tiled_body(torch, dev, parent_tiled, v, x, y, gain, (ny, nx))
    k4_rec = dict(common, mode="gain, (ny, nx) query grid, planned", **k4_build,
                  **k4_planned(torch, dev, v, x, y, gain, (ny, nx), plan, want4, parents, reps))
    # the off-plan body on the library's work (a 1-D stream), held to the
    # plain version before it is timed there
    k4_rec.update(k4_stream(torch, dev, vflat, xs, ys, (ny, nx)))
    k4_rec.update(plain_ms=median_ms(torch, lambda: bilinear.bilinear_scatter_adjoint_plain(
                      v, x, y, (ny, nx), gain), 3),
                  library_ms=median_ms(torch, lib_adjoint, reps),
                  library_work_ms=median_ms(torch, lambda: bc.bilinear_scatter_adjoint(
                      vflat, xs, ys, (ny, nx)), reps),
                  **bounds(8 * (3 * n + 2 * npix) + plan.nbytes, ADJOINT_FLOP * n_in, floor_ms))
    k4_rec["share_of_roofline"] = k4_rec["roofline_ms"] / k4_rec["ms"]
    for rec in (k3, k4_rec):
        assert rec["max_abs_err"] < TOL, rec
    return k3, k4_rec, plan_kernel_record(k4_rec, x, floor_ms)


def tap_pixels(torch, x, y, shape):
    """(the in-bounds queries at (x, y), the distinct pixels of a (ny, nx) =
    `shape` grid that their 2 x 2 taps cover)."""
    from pyimcom_tpu_torch.ops import bilinear

    inb = bilinear.in_bounds(x, y, shape)
    x0, y0 = torch.floor(x[inb]).long(), torch.floor(y[inb]).long()
    hit = torch.zeros(shape, dtype=torch.bool, device=x.device)
    for dy in (0, 1):
        for dx in (0, 1):
            hit[y0 + dy, x0 + dx] = True
    return int(inb.sum()), int(hit.sum())


def k4_shrunk(torch, dev, v, x, y, gain, shape, floor_ms, planned_ms, reps):
    """K4 on a map shrunk 0.1x (a tile's queries over more query rows than
    the plan kernel's ring): its plan overflows, so K4 without a plan and
    over that plan each take the off-plan body (bilinear_cuda.plan_route):
    the launches by route, the tiles off the plan against
    predict_off_plan_tiles, the errors against the plain version, and the
    device ms over its plan (its output's zero fill with it) beside the
    planned body's on the 0-degree pair (`planned_roll0_ms`).  Bytes: the
    values and positions of every query, each output pixel written once
    (8 B), and the gain read at each pixel the queries tap (`tap_pixels`)."""
    from pyimcom_tpu_torch.ops import bilinear, bilinear_cuda as bc

    plan = bc.build_adjoint_plan(x, y, shape)
    want = bilinear.bilinear_scatter_adjoint_plain(v, x, y, shape, gain)
    predicted = bc.predict_off_plan_tiles(x, y, shape, plan)
    routes0, off0 = dict(bc.adjoint_routes), bc.off_plan_tiles(dev)
    got = bc.bilinear_scatter_adjoint(v, x, y, shape, gain)
    off_no_plan = bc.off_plan_tiles(dev) - off0
    over = bc.bilinear_scatter_adjoint(v, x, y, shape, gain, plan=plan)
    off_over = bc.off_plan_tiles(dev) - off0 - off_no_plan
    routes = {k: bc.adjoint_routes[k] - routes0[k] for k in routes0}
    n_in, taps = tap_pixels(torch, x, y, shape)
    rec = dict(queries=x.numel(), in_bounds=n_in, tap_pixels=taps, plan_over=plan.over,
               plan_route=bc.plan_route(plan), launches=routes,
               off_plan_tiles=[off_no_plan, off_over], predicted_off_plan_tiles=predicted,
               max_abs_err=rel_err(torch, got, want),
               max_abs_err_over_plan=rel_err(torch, over, want),
               ms=median_ms(torch, lambda: bc.bilinear_scatter_adjoint(v, x, y, shape, gain,
                                                                       plan=plan), reps),
               planned_roll0_ms=planned_ms, reps=reps,
               plain_ms=median_ms(torch, lambda: bilinear.bilinear_scatter_adjoint_plain(
                   v, x, y, shape, gain), 3),
               **bounds((8 + 2 * x.element_size()) * x.numel() + 8 * shape[0] * shape[1]
                        + 8 * taps, ADJOINT_FLOP * n_in, floor_ms))
    assert rec["plan_route"] == "stream" and rec["plan_over"] > 0, rec
    assert routes == {"planned": 0, "stream": 2}, rec
    assert off_no_plan == off_over == predicted > 0, rec
    assert rec["max_abs_err"] < TOL and rec["max_abs_err_over_plan"] < TOL, rec
    return rec


def shrunk_destripe(torch, dev, v, gain, maps, shrunk):
    """A DestripeCost of two SCAs from the phase's tensors (images v and
    its transpose, gains `gain` and its transpose, float64 maps on the
    card): pair (0, 1) on the map `maps`, pair (1, 0) on the shrunk map
    `shrunk`.  Its plans' read-back (every plan's counts read at the build,
    none in a gradient, which runs under torch's sync debug mode "error"),
    each pair's route, K4's launches by route and tiles off the plan in one
    value_and_grad, and that against value_and_grad(plain=True): cost to
    rtol 1e-12, gradient to rtol 1e-9 and atol 1e-12."""
    from pyimcom_tpu_torch.ops import bilinear_cuda as bc, destripe_device

    host = lambda t: t.cpu().numpy()                       # noqa: E731
    t0 = time.perf_counter()
    dc = destripe_device.DestripeCost(
        host(torch.stack([v, v.t()])), host(torch.stack([gain, gain.t()])), None,
        [(0, 1), (1, 0)], [host(maps[0]), host(shrunk[0])], [host(maps[1]), host(shrunk[1])],
        amp_cols=128, device=dev)
    build_s = time.perf_counter() - t0
    read_at_build = all("_counts" in pl.__dict__ for pl in dc.plans)
    p = torch.as_tensor(np.random.default_rng(16).normal(scale=0.01, size=2 * dc.np_each),
                        device=dev)
    routes0, off0 = dict(bc.adjoint_routes), bc.off_plan_tiles(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        e_k, g_k = dc.value_and_grad(p)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    routes = {k: bc.adjoint_routes[k] - routes0[k] for k in routes0}
    off = bc.off_plan_tiles(dev) - off0
    e_p, g_p = dc.value_and_grad(p, plain=True)
    rec = dict(pairs=dc.pairs, image=[dc.ny, dc.nx], build_s=build_s,
               plans_read_at_build=read_at_build,
               pair_routes=[bc.plan_route(pl) for pl in dc.plans], launches=routes,
               off_plan_tiles=off,
               predicted_off_plan_tiles=bc.predict_off_plan_tiles(*shrunk, (dc.ny, dc.nx),
                                                                  dc.plans[1]),
               cost_rel=abs(float(e_k - e_p)) / abs(float(e_p)),
               grad_max_excess=float(((g_k - g_p).abs() - 1e-9 * g_p.abs()).max()),
               grad_scale=float(g_p.abs().max()))
    assert read_at_build and rec["pair_routes"] == ["planned", "stream"], rec
    assert routes == {"planned": 1, "stream": 1}, rec
    assert off == rec["predicted_off_plan_tiles"] > 0, rec
    assert rec["cost_rel"] < 1e-12 and rec["grad_max_excess"] <= 1e-12, rec
    return rec


# X7's projection: tests/test_wcs.py's block projection (CTR 60.0504, -3.8,
# LONPOLE 240, 0.04" a pixel), centred on a 4088^2 grid; the bound on (x, y)
# between two forms of it: one float64 epsilon of an angle over the pixel
# scale in radians (world2pix divides its angles' rounding by it: a one-ulp
# difference of a trigonometric function, torch's CPU and CUDA ones, comes
# to ~1e-10 px at this scale), as tests/test_torch_wcs.py's pix_tol
X7_CRVAL, X7_LONPOLE, X7_SCALE = (60.0504, -3.8), 240.0, 0.04 / 3600
X7_DEG_TOL = 1e-12
X7_PIX_TOL = float(max(1e-10, np.finfo(np.float64).eps / np.deg2rad(X7_SCALE)))


def x7_record(torch, dev, n, floor_ms, reps=10):
    """X7, wcsutil.stg_projection_torch, on the n^2 pixel centres of an n^2
    grid on the card against the same call on CPU float64 tensors: pix2world
    (max |d ra| as an angle and |d dec|, degrees) and world2pix of the CPU's
    (ra, dec) (max |d x|, |d y|, pixels); each one's device ms with its bytes
    bound (16 B in and 16 B out a point)."""
    from pyimcom_tpu_torch.wcsutil import stg_projection_torch

    c = (n - 1) / 2.0
    p2w, w2p = stg_projection_torch(X7_CRVAL, (c, c), (-X7_SCALE, X7_SCALE), X7_LONPOLE)
    yy, xx = torch.meshgrid(torch.arange(n, dtype=torch.float64, device=dev),
                            torch.arange(n, dtype=torch.float64, device=dev), indexing="ij")
    xx, yy = xx.contiguous(), yy.contiguous()
    ra, dec = p2w(xx, yy)
    t0 = time.perf_counter()
    ra_c, dec_c = p2w(xx.cpu(), yy.cpu())
    x_c, y_c = w2p(ra_c, dec_c)
    cpu_s = time.perf_counter() - t0
    ra_cd, dec_cd = ra_c.to(dev), dec_c.to(dev)
    x_d, y_d = w2p(ra_cd, dec_cd)
    d_ra = float(((ra - ra_cd + 180.0) % 360.0 - 180.0).abs().max())
    rec = dict(points=n * n, crval=list(X7_CRVAL), lonpole=X7_LONPOLE, scale_deg=X7_SCALE,
               max_abs_err_deg=max(d_ra, float((dec - dec_cd).abs().max())),
               max_abs_err_px=max(float((x_d - x_c.to(dev)).abs().max()),
                                  float((y_d - y_c.to(dev)).abs().max())),
               roundtrip_px=max(float((x_d - xx).abs().max()), float((y_d - yy).abs().max())),
               deg_bound=X7_DEG_TOL, px_bound=X7_PIX_TOL, cpu_s=cpu_s,
               finite=bool(torch.isfinite(ra).all() and torch.isfinite(x_d).all()),
               pix2world_ms=median_ms(torch, lambda: p2w(xx, yy), reps),
               world2pix_ms=median_ms(torch, lambda: w2p(ra_cd, dec_cd), reps), reps=reps,
               route="plain torch (no hand kernel, no library call)",
               **bounds(32 * n * n, 0, floor_ms))
    assert rec["finite"] and rec["max_abs_err_deg"] < X7_DEG_TOL, rec
    assert rec["max_abs_err_px"] < X7_PIX_TOL and rec["roundtrip_px"] < 1e-8, rec
    return rec


def phase_k4_synthetic(torch, dev, floor_ms, parent_tiled, reps=10):
    """K4 on k4_variants.py's synthetic 4088^2 pair (the target's pixels
    rolled by 0 and 45 degrees about the centre and shifted; seeded values
    and a gain in [0.5, 2] made on the card), with float64 positions and
    their float32 rounding, over the plan of each: k4_planned's record
    beside commit 28a3190's body (both forms) where built, and its bounds;
    then the same pixels shrunk 0.1x and rolled by 30 degrees, both forms,
    whose plan overflows (k4_shrunk), a DestripeCost holding that map
    (shrunk_destripe), and X7 on the grid's 4088^2 points (x7_record)."""
    from pyimcom_tpu_torch.ops import bilinear, bilinear_cuda as bc

    n = 4088
    gen = torch.Generator(device=dev).manual_seed(20261017)
    gain = 0.5 + 1.5 * torch.rand((n, n), generator=gen, dtype=torch.float64, device=dev)
    v = torch.randn((n, n), generator=gen, dtype=torch.float64, device=dev)
    yy, xx = torch.meshgrid(torch.arange(n, dtype=torch.float64, device=dev) - n / 2,
                            torch.arange(n, dtype=torch.float64, device=dev) - n / 2,
                            indexing="ij")
    out, maps = {}, {}
    for roll in (0, 45):
        th = np.deg2rad(roll)
        x64 = (np.cos(th) * xx - np.sin(th) * yy + n / 2 + 300.3).contiguous()
        y64 = (np.sin(th) * xx + np.cos(th) * yy + n / 2 - 200.7).contiguous()
        maps[roll] = (x64, y64)
        for form, (x, y) in (("f64", (x64, y64)), ("f32", (x64.float(), y64.float()))):
            fn = (parent_tiled or {}).get(form)
            plan = bc.build_adjoint_plan(x, y, (n, n))
            want = bilinear.bilinear_scatter_adjoint_plain(v, x, y, (n, n), gain)
            parents = {} if fn is None else {"tiled": tiled_body(torch, dev, fn, v, x, y, gain,
                                                                (n, n))}
            n_in = int(bilinear.in_bounds(x, y, (n, n)).sum())
            rec = dict(queries=n * n, in_bounds=n_in,
                       **k4_planned(torch, dev, v, x, y, gain, (n, n), plan, want, parents,
                                    reps),
                       **bounds((8 + 2 * x.element_size()) * n * n + 16 * n * n + plan.nbytes,
                                ADJOINT_FLOP * n_in, floor_ms))
            out[f"roll{roll}/{form}"] = rec
            del want
    th = np.deg2rad(30)
    shrunk = ((0.1 * (np.cos(th) * xx - np.sin(th) * yy) + n / 2 + 0.3).contiguous(),
              (0.1 * (np.sin(th) * xx + np.cos(th) * yy) + n / 2 - 0.7).contiguous())
    for form, (x, y) in (("f64", shrunk), ("f32", (shrunk[0].float(), shrunk[1].float()))):
        out[f"shrunk0.1/{form}"] = k4_shrunk(torch, dev, v, x, y, gain, (n, n), floor_ms,
                                             out[f"roll0/{form}"]["ms"], reps)
    out["shrunk0.1/destripe_cost"] = shrunk_destripe(torch, dev, v, gain, maps[0], shrunk)
    del maps, shrunk
    out["x7"] = x7_record(torch, dev, n, floor_ms, reps)
    emit({"phase": "k4_synthetic", "criterion": TOL, "image": [n, n], **out})
    return out


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


def phase_destripe(torch, dev, floor_ms, parent_k4, k4_build, parent_tiled=None):
    """imdestripe.main on 3 striped F184 SCAs at 4088^2 (6 ordered pairs)
    with 5 CG iterations, object mask and WCS gain on; K3 and K4 at the
    phase's shapes (and K4 on the synthetic pairs, phase_k4_synthetic);
    the kernel route of the cost against the plain route; the same maps in
    other storages (phase_destripe_storage); then the bench block coadded
    from the clean, striped and destriped inputs.  `parent_tiled`: commit
    28a3190's K4 entries by form, or None.  Returns (K3, K4 records, the
    main path's launches, the storage phase's (K3 f32, K4 f32 records, their
    launches))."""
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
    bilinear_cuda.reset_off_plan_tiles()
    t0 = time.perf_counter()
    with capture_destripe() as cap:
        params, history = imdestripe.main(Config(d), maxiter=5)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = dict(bilinear_cuda.launches)
    k4_routes = dict(bilinear_cuda.adjoint_routes)
    off_plan = bilinear_cuda.off_plan_tiles(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    # imdestripe.main stores its maps at float64 on the card: the f64 forms
    assert launches["bilinear_gather"] > 0 and launches["bilinear_scatter_adjoint"] > 0, launches
    assert launches["bilinear_gather.f32"] == launches["bilinear_scatter_adjoint.f32"] == 0
    # every K4 launch over its pair's plan, no tile off it
    assert k4_routes == {"planned": launches["bilinear_scatter_adjoint"], "stream": 0}, k4_routes
    assert off_plan == 0, off_plan
    prob = cap.problem
    dc = prob.device_cost
    assert len(dc.pairs) == 6 and dc.imgs.shape == (3, 4088, 4088), (dc.pairs, dc.imgs.shape)
    # a plan a pair, by the plan kernel (one launch)
    assert launches["bilinear_adjoint_plan"] == len(dc.pairs), launches
    assert launches["bilinear_adjoint_plan.f32"] == 0, launches
    plans = {"r": [pl.r for pl in dc.plans], "bytes": [pl.nbytes for pl in dc.plans],
             "pair_f32_map_bytes": 2 * 4 * dc.ny * dc.nx}
    assert max(plans["bytes"]) < 0.01 * plans["pair_f32_map_bytes"], plans

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
          "K4_routes": k4_routes, "K4_off_plan_tiles": off_plan, "K4_plans": plans,
          "cost_and_grad_device_ms": cg_ms, "cost_and_grad_host_s": cg_host_s,
          "cost_and_grad_trace": trace if trace is not None else "not measured",
          "routes": routes, "row_median_std": quality, "improved": improved})
    assert len(quality) == 3 and history[-1]["cost"] < cost0, quality
    assert improved >= len(quality) // 2, quality

    # ---- K3 and K4 alone at the phase's shapes ----
    k3, k4, plan_rec = bilinear_records(torch, dev, dc, floor_ms, parent_k4, k4_build,
                                        None if parent_tiled is None else parent_tiled["f64"])
    emit({"phase": "bilinear_kernels", "criterion": TOL, "K3": k3, "K4": k4,
          "K4_plan": plan_rec, "K4_plan_economy": plan_economy(k4, launches, len(dc.pairs))})
    phase_k4_synthetic(torch, dev, floor_ms, parent_tiled)
    torch.cuda.empty_cache()

    # ---- the same maps at float32, on the card and streamed ----
    storage = phase_destripe_storage(torch, dev, prob, p_rand, floor_ms, parent_tiled)
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
    return k3, k4, plan_rec, launches, storage


def plan_economy(k4, launches, pairs):
    """What the plans cost and save on the main path's K4 work, from this
    run's first-pair times (K4 over its plan and the tiled body of commit
    28a3190 in turns, the plan kernel's build) and its launches: K4's device
    ms before (every launch at the tiled body's time) and after (at the
    planned time, plus a plan a pair), and the gradients a pair at which a
    plan pays for itself; None without the tiled body."""
    if "tiled_ms" not in k4:
        return None
    saving = k4["tiled_ms"] - k4["ms"]
    n = launches["bilinear_scatter_adjoint"]
    return dict(k4_launches=n, pairs=pairs, gradients_per_pair=n / pairs,
                plan_build_ms=k4["plan_build_ms"], saving_per_launch_ms=saving,
                break_even_gradients=k4["plan_build_ms"] / saving if saving > 0 else None,
                k4_ms_before=n * k4["tiled_ms"],
                k4_ms_after=n * k4["ms"] + pairs * k4["plan_build_ms"])


def destripe_cost_like(prob, xf, yf, dev, **kw):
    """A DestripeCost of DestripeProblem `prob`'s images, gains and masks
    (as the problem builds its own) on the maps xf, yf, with the storage
    keywords `kw`."""
    from pyimcom_tpu_torch.ops.destripe_device import DestripeCost

    mask = prob.mask
    return DestripeCost(np.stack([s.image for s in prob.scas]),
                        np.stack([s.g_eff for s in prob.scas]),
                        None if mask is None else np.stack(mask), prob.device_cost.pairs, xf, yf,
                        amp_cols=prob.amp_cols, cost_model=prob.cost_model, hub=prob.hub,
                        col_boundary_const=prob.col_boundary_const,
                        bmasks=[mask[i] if mask is not None else s.mask
                                for i, s in enumerate(prob.scas)], device=dev, **kw)


def phase_destripe_storage(torch, dev, prob, p_rand, floor_ms, parent_tiled=None):
    """The destripe phase's 6 pair maps in three storages (f64 / device,
    f32 / device, f32 / host): each route's memory, time, launches by form
    and K4's by route (every one over a plan, no tile off it), the f32
    routes held to the f64 route on the same (widened) positions, what the
    rounding to float32 changes, what each route fits on the card; then K3 /
    K4's float32 forms alone (K4 beside commit 28a3190's where
    `parent_tiled` holds it).  Returns (the K3 and K4 f32 records, the
    launches of the f32 routes' cost-and-gradients)."""
    from pyimcom_tpu_torch.imdestripe import to_memmap
    from pyimcom_tpu_torch.ops import bilinear_cuda

    dc = prob.device_cost
    P, S, ny, nx = len(dc.pairs), dc.S, dc.ny, dc.nx
    t0 = time.perf_counter()
    x64 = [t.cpu().numpy() for t in dc.xf]
    y64 = [t.cpu().numpy() for t in dc.yf]
    x32 = [a.astype(np.float32) for a in x64]
    y32 = [a.astype(np.float32) for a in y64]
    wide = ([a.astype(np.float64) for a in x32], [a.astype(np.float64) for a in y32])
    # the streamed route's maps as DestripeProblem(map_dtype="f32",
    # memmap=True) hands them over: float32 memory-mapped files, which the
    # cost views in place and uploads from their pageable pages
    mdir = WORK / "destripe" / "maps_f32"
    mdir.mkdir()
    mm = ([to_memmap(a, str(mdir), f"xf_{p}") for p, a in enumerate(x32)],
          [to_memmap(a, str(mdir), f"yf_{p}") for p, a in enumerate(y32)])
    host_maps_s = time.perf_counter() - t0
    rounding = {"max_position_change_px": float(max(
        np.nanmax(np.abs(w - a)) for w, a in zip(wide[0] + wide[1], x64 + y64)))}
    p_np = p_rand.cpu().numpy()
    cost64, grad64 = prob.cost_and_grad(p_np)
    routes, costs = {}, {}
    f32_launches = {"bilinear_gather.f32": 0, "bilinear_scatter_adjoint.f32": 0,
                    "bilinear_adjoint_plan.f32": 0}
    for name, xs, ys, kw in (("f64/device", *wide, {}),
                             ("f32/device", x32, y32, dict(map_dtype="f32")),
                             ("f32/host", *mm, dict(map_dtype="f32", map_store="host"))):
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        bilinear_cuda.reset_launch_counts()
        t0 = time.perf_counter()
        c = costs[name] = destripe_cost_like(prob, xs, ys, dev, **kw)
        torch.cuda.synchronize(dev)
        build_s = time.perf_counter() - t0
        form = ".f32" if "f32" in name else ""
        # a plan a pair, by the plan kernel's form for these maps
        plan_launches = bilinear_cuda.launches["bilinear_adjoint_plan" + form]
        assert plan_launches == P, (name, bilinear_cuda.launches)
        if form:
            f32_launches["bilinear_adjoint_plan.f32"] += plan_launches
        resident = torch.cuda.memory_allocated(dev) - before
        build_peak = torch.cuda.max_memory_allocated(dev) - before
        torch.cuda.reset_peak_memory_stats(dev)
        bilinear_cuda.reset_launch_counts()
        bilinear_cuda.reset_off_plan_tiles()
        host_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            cost, grad = c.cost_and_grad(p_np)
            host_s.append(time.perf_counter() - t0)
        if name != "f64/device":
            for k in ("bilinear_gather.f32", "bilinear_scatter_adjoint.f32"):
                f32_launches[k] += bilinear_cuda.launches[k]
        launches = {k: v // 3 for k, v in bilinear_cuda.launches.items()}
        k4_routes = {k: v // 3 for k, v in bilinear_cuda.adjoint_routes.items()}
        off_plan = bilinear_cuda.off_plan_tiles(dev)
        cost_peak = torch.cuda.max_memory_allocated(dev) - before
        peak = max(build_peak, cost_peak)
        assert launches[f"bilinear_gather{form}"] == P, (name, launches)
        assert launches[f"bilinear_scatter_adjoint{form}"] == P, (name, launches)
        assert k4_routes == {"planned": P, "stream": 0} and off_plan == 0, (name, k4_routes,
                                                                            off_plan)
        rec = dict(build_s=build_s, plan_launches=plan_launches,
                   resident_GiB=resident / 2 ** 30, peak_GiB=peak / 2 ** 30, peak_bytes=peak,
                   resident_bytes=resident, build_peak_bytes=build_peak,
                   cost_peak_bytes=cost_peak, cost_and_grad_host_s=statistics.median(host_s),
                   cost_and_grad_device_ms=statistics.median(device_times(
                       torch, lambda c=c: c.value_and_grad(p_rand), 5,
                       sleep=20 * SLEEP_CYCLES)),
                   launches_per_cost_and_grad=launches, K4_routes_per_cost_and_grad=k4_routes,
                   K4_off_plan_tiles=off_plan, cost=cost)
        if c.maps is not None:
            # each map a view of its file, in pageable memory
            assert all(t.data_ptr() == a.ctypes.data and not t.is_pinned()
                       for t, a in zip(c.xf + c.yf, mm[0] + mm[1])), name
            rec["uploads"] = c.maps.uploads
            rec["host_storage"] = "memory-mapped files (pageable)"
        if name == "f64/device":
            base_cost, base_grad = cost, grad
            rounding.update(cost_rel_change=abs(cost - cost64) / abs(cost64),
                            grad_rel_change=float(np.abs(grad - grad64).max()
                                                  / np.abs(grad64).max()))
        else:
            rec["vs_f64_device"] = {
                "cost_rel": abs(cost - base_cost) / abs(base_cost),
                "grad_max_excess": float((np.abs(grad - base_grad)
                                          - 1e-9 * np.abs(base_grad)).max())}
        routes[name] = rec
    pair_bytes = {"f64": 2 * 8 * ny * nx, "f32": 2 * 4 * ny * nx}
    gap = routes["f32/device"]["peak_bytes"] - routes["f32/host"]["peak_bytes"]
    # what each route fits on this card, reckoned from the peaks: a device
    # route's peak holds every pair's maps, the rest taken as a share of
    # each SCA; the streamed route's peak (at the end of the forward, outside
    # any walk) holds no map, and its two slots are counted on top
    total = torch.cuda.mem_get_info(dev)[1]
    fits = {}
    for name, rec in routes.items():
        pb = pair_bytes[name[:3]]
        if name == "f32/host":
            per_sca = rec["peak_bytes"] / S
            fits[name] = dict(per_sca_bytes=per_sca, per_pair_bytes=0,
                              scas_at_2_pairs_each=int((total - 2 * pb) // per_sca),
                              pairs_beside_3_scas="not bound by the card")
        else:
            per_sca = (rec["peak_bytes"] - P * pb) / S
            fits[name] = dict(per_sca_bytes=per_sca, per_pair_bytes=pb,
                              scas_at_2_pairs_each=int(total // (per_sca + 2 * pb)),
                              pairs_beside_3_scas=int((total - 3 * per_sca) // pb))
    k3, k4, plan_rec = bilinear_f32_records(
        torch, dev, costs["f32/device"], floor_ms,
        None if parent_tiled is None else parent_tiled["f32"])
    emit({"phase": "destripe_storage", "pairs": P, "scas": S, "image": [ny, nx],
          "host_maps_s": host_maps_s, "routes": routes,
          "pair_map_bytes": pair_bytes, "f32_device_minus_host_peak_bytes": gap,
          "fits_on_card": fits, "card_bytes": total, "f32_rounding": rounding,
          "kernels": {"K3_f32": k3, "K4_f32": k4, "K4_plan_f32": plan_rec},
          "K4_plan_economy_f32": plan_economy(
              k4, {"bilinear_scatter_adjoint": f32_launches["bilinear_scatter_adjoint.f32"]},
              2 * P)})
    for name, rec in routes.items():
        if name != "f64/device":
            assert rec["vs_f64_device"]["cost_rel"] < 1e-12, (name, rec)
            assert rec["vs_f64_device"]["grad_max_excess"] <= 1e-12, (name, rec)
    # the card holds the streamed route's maps for two pairs at a time
    assert gap >= 4 * pair_bytes["f32"], (gap, pair_bytes)
    del costs, mm
    shutil.rmtree(mdir)
    return k3, k4, plan_rec, f32_launches


def bilinear_f32_records(torch, dev, dc, floor_ms, parent_tiled=None, reps=20):
    """K3 and K4's float32 forms on the first pair of a float32 on-card
    DestripeCost `dc`: device times against their plain versions (1e-12 of
    scale), their float64 forms on the widened positions, and grid_sample
    (bilinear, zeros, align_corners=True) and its input gradient on the
    points inside its region, at the widened positions (it takes no float32
    grid for a float64 image), and K3's float32 form doing only the
    library's work there (`library_work_ms`: the float32 positions inside
    its region, no gain, its result written, as the float64 record's).
    Bytes: K3 reads x and y (8 a query) and the accumulator and writes it
    (16), the image and the gain once; K4 reads the values (8) and x and y
    (8), its plan, the gain once and writes the output once; operations as
    the float64 forms'.  K4 runs over the cost's plan of the pair, with
    k4_planned's record, beside commit 28a3190's f32 entry
    (`parent_tiled`, the tiled body) where built; the off-plan body's f32
    form on the library's work, held to the plain version (k4_stream) and
    timed (`library_work_ms`).  Returns the K3 and K4 records and the plan
    kernel's (plan_kernel_record)."""
    import torch.nn.functional as F

    from pyimcom_tpu_torch.ops import bilinear, bilinear_cuda as bc

    _i, j = dc.pairs[0]
    img, gain, x, y, plan = dc.imgs[j], dc.ge[j], dc.xf[0], dc.yf[0], dc.plans[0]
    assert x.dtype == torch.float32, x.dtype
    x64, y64 = x.double(), y.double()
    ny, nx = img.shape
    n, npix = x.numel(), ny * nx
    inb = bilinear.in_bounds(x, y, (ny, nx))
    n_in = int(inb.sum())
    v = torch.as_tensor(np.random.default_rng(20261018).normal(size=x.shape), device=dev)
    acc = torch.zeros(x.shape, dtype=torch.float64, device=dev)
    got3 = bc.bilinear_gather(img, x, y, gain, out=acc.clone())
    want3 = bilinear.bilinear_gather_plain(img, x, y, gain)
    same3 = bool(torch.equal(got3, bc.bilinear_gather(img, x64, y64, gain, out=acc.clone())))
    want4 = bilinear.bilinear_scatter_adjoint_plain(v, x, y, (ny, nx), gain)
    xs, ys, vs = x64[inb], y64[inb], v[inb].reshape(1, 1, 1, -1)
    xs32, ys32 = x[inb], y[inb]
    grid = torch.stack([2 * xs / (nx - 1) - 1, 2 * ys / (ny - 1) - 1], -1).reshape(1, 1, -1, 2)
    inp = img.reshape(1, 1, ny, nx).clone().requires_grad_(True)
    out_gs = F.grid_sample(inp, grid, mode="bilinear", padding_mode="zeros", align_corners=True)

    def lib_gather():
        with torch.no_grad():
            F.grid_sample(inp, grid, mode="bilinear", padding_mode="zeros", align_corners=True)

    common = dict(pair=list(dc.pairs[0]), image=[ny, nx], queries=n, in_bounds=n_in,
                  position_dtype="float32", launch_floor_ms=floor_ms)
    k3 = dict(common, mode="accumulate, gain", max_abs_err=rel_err(torch, got3, want3),
              equals_f64_form_on_widened_positions=same3,
              ms=median_ms(torch, lambda: bc.bilinear_gather(img, x, y, gain, out=acc), reps,
                           setup=acc.zero_),
              f64_form_ms=median_ms(torch, lambda: bc.bilinear_gather(img, x64, y64, gain,
                                                                      out=acc), reps,
                                    setup=acc.zero_),
              plain_ms=median_ms(torch, lambda: bilinear.bilinear_gather_plain(
                  img, x, y, gain), 3),
              library_ms=median_ms(torch, lib_gather, reps),
              library_work_ms=median_ms(torch, lambda: bc.bilinear_gather(img, xs32, ys32), reps),
              **bounds(24 * n + 16 * npix, GATHER_FLOP * n_in, floor_ms))
    parents = ({} if parent_tiled is None else
               {"tiled": tiled_body(torch, dev, parent_tiled, v, x, y, gain, (ny, nx))})
    plan64 = bc.build_adjoint_plan(x64, y64, (ny, nx))
    vflat = vs.reshape(-1)
    k4 = dict(common, mode="gain, (ny, nx) query grid, planned",
              **k4_planned(torch, dev, v, x, y, gain, (ny, nx), plan, want4, parents, reps),
              **k4_stream(torch, dev, vflat, xs32, ys32, (ny, nx)),
              f64_form_ms=median_ms(torch, lambda: bc.bilinear_scatter_adjoint(
                  v, x64, y64, (ny, nx), gain, plan=plan64), reps),
              library_work_ms=median_ms(torch, lambda: bc.bilinear_scatter_adjoint(
                  vflat, xs32, ys32, (ny, nx)), reps),
              plain_ms=median_ms(torch, lambda: bilinear.bilinear_scatter_adjoint_plain(
                  v, x, y, (ny, nx), gain), 3),
              library_ms=median_ms(torch, lambda: torch.autograd.grad(
                  out_gs, inp, vs, retain_graph=True), reps),
              **bounds(16 * n + 16 * npix + plan.nbytes, ADJOINT_FLOP * n_in, floor_ms))
    for rec in (k3, k4):
        rec["share_of_roofline"] = rec["roofline_ms"] / rec["ms"]
        assert rec["max_abs_err"] < TOL, rec
    assert same3, k3
    return k3, k4, plan_kernel_record(k4, x, floor_ms)


def phase_mosaic_chain():
    """pyimcom_tpu_torch.pipeline with scripts/run_chained_pipeline.py's
    defaults and --n-obs 6, its launch counts set to 0 just before and read
    just after; the criteria of the module docstring.  Returns its line."""
    from pyimcom_tpu_torch import pipeline
    from pyimcom_tpu_torch.fitsio import fits_read
    from pyimcom_tpu_torch.ops import bilinear_cuda, interp_cuda

    interp_cuda.reset_launch_counts()
    bilinear_cuda.reset_launch_counts()
    bilinear_cuda.reset_off_plan_tiles()
    res = pipeline.run(WORK / "mosaic_chain", n_obs=6, report=False)
    in_process = {**interp_cuda.launches, **bilinear_cuda.launches}
    k4_routes = dict(bilinear_cuda.adjoint_routes)
    off_plan = bilinear_cuda.off_plan_tiles("cuda:0")
    finite = {Path(p).name: all(bool(np.all(np.isfinite(np.asarray(h.data))))
                                for h in fits_read(p) if getattr(h, "data", None) is not None
                                and np.asarray(h.data).dtype.kind in "fiu")
              for p in res["coadd_block_s"]}
    emit({"phase": "mosaic_chain", **res, "launches_in_process": in_process,
          "K4_routes": k4_routes, "K4_off_plan_tiles": off_plan,
          "finite": finite, "report": "left out: the card's machine has no matplotlib"})
    st = res["launches"]
    assert st["destripe"]["bilinear_gather"] > 0 and st["destripe"]["bilinear_scatter_adjoint"] > 0
    assert k4_routes["stream"] == 0 and k4_routes["planned"] > 0 and off_plan == 0, \
        (k4_routes, off_plan)
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


def phase_multi_device(torch, cfg_dict, single_out):
    """The bench block with its groups in column bands over every card, or
    over two bands of the one card: held to the warm one-device block
    `single_out`; returns the launches."""
    n = torch.cuda.device_count()
    devices = ([torch.device("cuda", k) for k in range(n)] if n > 1
               else [torch.device("cuda", 0)] * 2)
    blk, out, t, launches = run_block(cfg_dict, "_mesh", block_kw=dict(devices=devices))
    for d in set(devices):
        torch.cuda.synchronize(d)
    cmp = compare_blocks(single_out, out)
    emit({"phase": "multi_device", "devices": [str(d) for d in devices],
          "cards": n, "stamps": len(blk.stamp_stats), "block_s": t,
          "round_stats": blk._round_stats, "cross_device_puts": blk._cross_device_puts,
          "seams_recomputed": blk.pool_stats["recomputed"], "vs_one_device": cmp,
          "launches": launches, "phases": phase_times(blk)})
    assert len(blk.stamp_stats) == 16 and blk._cross_device_puts == 0, blk.stamp_stats
    assert blk._round_stats is not None and blk.pool_stats["recomputed"] > 0
    assert cmp["science_rel"] <= TOL and max(cmp["maps_lsb"].values()) <= 1, cmp
    return launches


def phase_multi_device_row(torch, cfg_dict):
    """A production row of 8 groups (STOP 32) on one card and with its
    groups in bands over every card (two groups a band on four): seconds,
    the comparison, seams, round statistics and each card's peak memory."""
    devs = [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
    prod = dict(PROD, STOP=32)
    blk1, out1, t1, _l = run_block(cfg_dict, "_prodrow1", **prod)
    for d in devs:
        torch.cuda.reset_peak_memory_stats(d)
    blkn, outn, tn, launches = run_block(cfg_dict, "_prodrowN", block_kw=dict(devices=devs),
                                         **prod)
    for d in devs:
        torch.cuda.synchronize(d)
    cmp = compare_blocks(out1, outn)
    emit({"phase": "multi_device_production_row", "stamps": len(blkn.stamp_stats),
          "devices": [str(d) for d in devs], "one_device_s": t1, "banded_s": tn,
          "round_stats": blkn._round_stats, "cross_device_puts": blkn._cross_device_puts,
          "seams_recomputed": blkn.pool_stats["recomputed"], "vs_one_device": cmp,
          "launches": launches,
          "peak_GiB": [torch.cuda.max_memory_allocated(d) / 2 ** 30 for d in devs],
          "phases_banded": phase_times(blkn), "phases_one_device": phase_times(blk1)})
    assert len(blkn.stamp_stats) == 32 and blkn._cross_device_puts == 0
    assert cmp["science_rel"] <= TOL and max(cmp["maps_lsb"].values()) <= 1, cmp


def multi_device_only(torch):
    """``--multi-device``: the bench survey's cold and warm one-device block,
    then multi_device and multi_device_production_row on every card."""
    from survey_fixture_torch import build_survey

    from pyimcom_tpu_torch import _build

    _build.build("interp_d5512")
    shutil.rmtree(WORK, ignore_errors=True)
    cfg_dict = build_survey(WORK, n_obs=8, extrainput=["cstar14"])
    run_block(cfg_dict, "_cold")
    _blk, out, t, _l = run_block(cfg_dict, "_bench")
    emit({"phase": "bench_block", "block_s": t})
    phase_multi_device(torch, cfg_dict, out)
    phase_multi_device_row(torch, cfg_dict)


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
    task_routes = dict(interp_cuda.dense_routes)
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
           "task_launches": task_launches, "task_k1_routes": task_routes,
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
    # every K1<8> launch of the wing canvases takes the canvas body
    assert task_routes == {"runs": 0, "canvas": task_launches["interp_g4460_dense"]}, \
        task_routes
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


def phase_g4460_kernels(torch, dev, k1_caps, plan, floor_ms, parent_k2):
    """K1<8> alone on its captured main-path launches -- PSF sampling of
    the G4460 bench block and the first wing canvas of the split-PSF loop's
    wing-subtraction task (at oversampling 3, at most 2^22 of its queries)
    -- and K2<8> (pool, B) on the G4460 bench block's first group, against
    their plain versions (and beside K2 of commit 910c170 where built).
    Returns (the K1 records, the K2 record)."""
    k1 = {key: k1_main_path(torch, dev, key, k1_caps.pop(key), floor_ms, None)
          for key in ("g4460/psf_sampling", "psfsplit/wing_canvas")}
    k2 = k2_main_path(torch, dev, "g4460_bench_group_1", plan, floor_ms, parent_k2)
    emit({"phase": "g4460_kernels", "criterion": TOL, "K1": k1, "K2": k2})
    return k1, k2


# the production wing canvas (PERF.md section 4): a 4088^2 SCA at
# oversampling 3 with the binned kernels' pad (A = 12324, 0.11" / 3 a
# point) over mosaic blocks of 2560^2 at 0.0390625" padded by BLOCK_PAD to
# 2572^2; a canvas point steps WING_SCALE block pixels
WING_A, WING_N, WING_PAD = 12324, 2560, 6
WING_SCALE = (0.11 / 3) / 0.0390625
WING_SLICE = 1 << 22            # queries of a launch held to the plain version


def wing_queries(torch, dev, roll, origin, N, centre):
    """The canvas points that the block of N^2 pixels at `origin` (mosaic
    pixels) reaches, made on the card: the WING_A^2 canvas mapped into the
    mosaic by a roll of `roll` degrees and a scale of WING_SCALE about
    `centre`, its points inside (-5.5, N + 4.5) in the block's pixels
    (CanvasGeometry.on_block's rule), as build_wing_canvas hands them to K1:
    x, y (1, Nq) in the padded block, row-major, and their canvas-row
    segments (interp_cuda.CanvasSegments, from each row's first column and
    count: the footprint is convex).  None where no point falls inside."""
    from pyimcom_tpu_torch.ops import interp_cuda

    th = np.deg2rad(roll)
    c, s_ = np.cos(th) * WING_SCALE, np.sin(th) * WING_SCALE
    h = (WING_A - 1) / 2.0
    # the canvas box that can reach the block (the inverse map of its corners)
    corners = np.array([[-6.0, -6.0], [N + 5.0, -6.0], [-6.0, N + 5.0], [N + 5.0, N + 5.0]])
    d = corners + np.asarray(origin, float) - np.asarray(centre, float)
    u = (c * d[:, 0] + s_ * d[:, 1]) / WING_SCALE ** 2 + h
    w = (-s_ * d[:, 0] + c * d[:, 1]) / WING_SCALE ** 2 + h
    c0, c1 = max(int(np.floor(u.min())) - 1, 0), min(int(np.ceil(u.max())) + 2, WING_A)
    r0, r1 = max(int(np.floor(w.min())) - 1, 0), min(int(np.ceil(w.max())) + 2, WING_A)
    if c1 <= c0 or r1 <= r0:
        return None
    f64 = dict(dtype=torch.float64, device=dev)
    uu = torch.arange(c0, c1, **f64)[None, :] - h
    ww = torch.arange(r0, r1, **f64)[:, None] - h
    xb = c * uu - s_ * ww + (centre[0] - origin[0])
    yb = s_ * uu + c * ww + (centre[1] - origin[1])
    inside = (xb > -5.5) & (xb < N + 4.5) & (yb > -5.5) & (yb < N + 4.5)
    cnt = inside.sum(1)
    if int(cnt.sum()) == 0:
        return None
    ii = inside.to(torch.int8)
    first = ii.argmax(1)
    last = ii.shape[1] - 1 - ii.flip(1).argmax(1)
    live = cnt > 0
    assert bool(((last - first + 1 == cnt) | ~live).all()), "a row of two segments"
    rows = torch.nonzero(live).reshape(-1)
    n = cnt[rows]
    seg = torch.stack([rows + r0, first[rows] + c0, torch.cumsum(n, 0) - n, n], 1)
    seg = seg.cpu().numpy().astype(np.int32)
    x = (xb[inside] + WING_PAD).reshape(1, -1)
    y = (yb[inside] + WING_PAD).reshape(1, -1)
    return x, y, interp_cuda.CanvasSegments(seg, interp_cuda.canvas_tiles(seg, WING_SCALE),
                                            abs(np.sin(th)) > abs(np.cos(th)), WING_SCALE)


def wing_launch(torch, dev, image, q, floor_ms, f_sm_hz, reps=10, streams_only=False):
    """One wing-canvas launch of K1<8> (image (1, n, n) and the points q of
    wing_queries): the canvas body once through interp2d_dense, as
    build_wing_canvas calls it; its time and that of the body of runs of 32
    queries in turns; the two equal bit for bit on the whole launch; the
    canvas body within TOL of the plain version on the first WING_SLICE
    queries; the bytes bound (image, x, y and the result once) and the
    shared-memory bound (64 eight-byte patch reads a query on the grid at
    128 bytes a clock an SM, 132 SMs at `f_sm_hz`); with `streams_only`
    also the runs body on the same queries moved off the grid (x, y read,
    zeros written, no image read)."""
    from pyimcom_tpu_torch.ops import interp, interp_cuda as ic

    x, y, hint = q
    _R, ny, nx = image.shape
    Nq = x.shape[1]
    before = ic.dense_routes["canvas"]
    got = interp.interp2d_dense(image, x, y, "G4460", segments=hint)
    assert ic.dense_routes["canvas"] == before + 1, ic.dense_routes
    runs = ic.interp_dense(image, x, y, "G4460")
    k = min(Nq, WING_SLICE)
    want = ic.interp_dense_plain(image, x[:, :k], y[:, :k], "G4460")
    fx, fy = torch.floor(x), torch.floor(y)
    on = int(((fx >= 3) & (fx < nx - 4) & (fy >= 3) & (fy < ny - 4)).sum())
    rec = dict(Nq=Nq, image=[ny, nx], on_grid=on, tiles=len(hint.tiles),
               segments=len(hint.segments), bit_identical_to_runs=bool(torch.equal(got, runs)),
               max_abs_err=rel_err(torch, got[:, :k], want), checked_queries=k)
    del runs, want
    calls = {"canvas": lambda: ic.interp_dense(image, x, y, "G4460", segments=hint),
             "runs": lambda: ic.interp_dense(image, x, y, "G4460")}
    t = in_turns(torch, calls, reps)
    rec.update(ms=t["canvas"], runs_ms=t["runs"],
               **bounds(8 * (image.numel() + 3 * Nq), QUERY_FLOP["G4460"] * on, floor_ms),
               smem_bound_ms=on * 512 / (128 * 132 * f_sm_hz) * 1e3)
    if streams_only:
        xo = x + 1e7
        rec["runs_streams_only_ms"] = median_ms(torch, lambda: ic.interp_dense(
            image, xo, y, "G4460"), reps)
    rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    assert rec["bit_identical_to_runs"] and rec["max_abs_err"] < TOL, rec
    return rec


def phase_wing_canvas_production(torch, dev, floor_ms):
    """K1<8>'s wing-canvas launches at production size, made on the card
    (wing_queries; seeded images from a torch.Generator on the card): one
    production block (2560^2 padded to 2572^2, at the canvas's centre) at
    rolls 0, 45 and 90 degrees; all the launches of one layer at 0 degrees, each
    block of the 2560-pixel grid that the canvas reaches; and one block
    covering the whole canvas (WING_A^2 queries, its ~1.07 GB image).
    Each launch as wing_launch records it (the canvas body beside the body
    of runs of 32 queries in turns).  Prints its line; returns (its
    record, the canvas body's launches counted, the worst error)."""
    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout
    f_sm = float(smi.split()[0]) * 1e6 if smi.strip() else 1.98e9
    gen = torch.Generator(device=dev).manual_seed(20261018)

    def image(n):
        return torch.randn((1, n, n), generator=gen, dtype=torch.float64, device=dev)

    side = WING_N + 2 * WING_PAD
    # the canvas's centre in mosaic pixels, off the block grid's lines
    centre = (3 * WING_N + 1021.3, 3 * WING_N + 733.7)
    mid = (3 * WING_N, 3 * WING_N)
    rec = {"phase": "wing_canvas_production", "canvas": WING_A, "block": WING_N,
           "padded_block": side, "scale": WING_SCALE, "sm_clock_hz": f_sm,
           "criterion": TOL, "slice": WING_SLICE}
    img = image(side)
    for roll in (0, 45, 90):
        rec[f"production_block_{roll}"] = wing_launch(
            torch, dev, img, wing_queries(torch, dev, roll, mid, WING_N, centre), floor_ms, f_sm)
    layer = []
    for iy in range(8):
        for ix in range(8):
            q = wing_queries(torch, dev, 0, (ix * WING_N, iy * WING_N), WING_N, centre)
            if q is not None:
                layer.append(wing_launch(torch, dev, image(side), q, floor_ms, f_sm, reps=4))
            del q
    rec["layer_0"] = dict(
        launches=len(layer), Nq=sum(r["Nq"] for r in layer),
        **{k: sum(r[k] for r in layer) for k in ("ms", "runs_ms", "bound_ms", "roofline_ms",
                                                 "smem_bound_ms")},
        max_abs_err=max(r["max_abs_err"] for r in layer),
        bit_identical_to_runs=all(r["bit_identical_to_runs"] for r in layer))
    del img
    torch.cuda.empty_cache()
    # one block covering the canvas: its side the canvas's reach, plus the pad
    n_cov = int(np.ceil(WING_SCALE * (WING_A - 1))) + 1
    corner = (centre[0] - WING_SCALE * (WING_A - 1) / 2, centre[1] - WING_SCALE * (WING_A - 1) / 2)
    q = wing_queries(torch, dev, 0, corner, n_cov, centre)
    rec["covering_0"] = wing_launch(torch, dev, image(n_cov + 2 * WING_PAD), q, floor_ms, f_sm,
                                    streams_only=True)
    del q
    torch.cuda.empty_cache()
    # the launches driven through interp2d_dense (each took the canvas body)
    n_canvas = rec["canvas_launches"] = 4 + len(layer)
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    assert rec["covering_0"]["Nq"] == WING_A * WING_A, rec["covering_0"]
    assert rec["layer_0"]["Nq"] >= WING_A * WING_A and rec["layer_0"]["bit_identical_to_runs"]
    errs = [rec[k]["max_abs_err"] for k in ("production_block_0", "production_block_45",
                                            "production_block_90", "layer_0", "covering_0")]
    return rec, n_canvas, max(errs)


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


def phase_piff_block(torch, dev, cfg_dict, bench, floor_ms, parent, parent_k2):
    """The bench block with Piff PSF files (module docstring, 11b): a first
    run, then the measured warm run, whose first K1 launch of PSF sampling
    and first group's K2 launches are held against their plain versions;
    one PSF group's draws timed and held to the CPU route.  K2<8> where its
    PSFs are oversampled 8x: the first group's rows launched as G4460, and
    the first group of a G4460 production group (PROD geometry, the Piff
    files drawn at 8x) run and captured.  `bench` holds the bench block's
    block_s, SL1 and uc_median.  Returns (the warm block's launches, the K1
    record, the K2 record, the K2<8> records); each K2 record beside K2 of
    commit 910c170 where built."""
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
    k2 = k2_main_path(torch, dev, "piff_group_1", plan_cap.plan, floor_ms, parent_k2)
    k2_8 = [k2_main_path(torch, dev, "piff_group_1", plan_cap.plan, floor_ms, parent_k2,
                         kern="G4460", time_plain=False)]
    del plan_cap.plan
    with capture_first_plan() as prod_cap:
        run_production(torch, dev, cfg_dict, "production_g4460_piff8", "_prodpiff",
                       PSFINTERP="G4460", **over)
    k2_8.append(k2_main_path(torch, dev, "production_g4460_piff8", prod_cap.plan, floor_ms,
                             parent_k2, time_plain=False))
    del prod_cap.plan
    for rec in [k2] + k2_8:
        emit({"phase": "k2_main_path", "criterion": TOL, **rec})
    return launches, k1, k2, k2_8


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
    ap.add_argument("--multi-device", action="store_true",
                    help="only the bench block over every card (multi_device) and a "
                         "production row over them")
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
    if args.multi_device:
        multi_device_only(torch)
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
    parent = parent_entry("interp_d5512", "interp_d5512_dense")
    parent_k4 = parent_entry("bilinear", "bilinear_scatter_adjoint")
    for dtype, sfx in ((torch.float64, ""), (torch.float32, "_f32")):
        fns = tuple(parent_entry("bilinear_plan", f"bilinear_adjoint_plan_{k}{sfx}")
                    for k in ("rows", "cols"))
        if None not in fns:
            PARENT_PLAN[dtype] = fns
    parent_tiled = {form: parent_entry("bilinear_tiled", "bilinear_scatter_adjoint" + sfx)
                   for form, sfx in (("f64", ""), ("f32", "_f32"))}
    if None in parent_tiled.values():
        parent_tiled = None
    parent_k2 = {kern: parent_entry("interp_d5512_pr12", entry)
                 for kern, entry in (("D5512", "sweep_d5512_scatter"),
                                     ("G4460", "sweep_g4460_scatter"))}
    if None in parent_k2.values():
        parent_k2 = None
    k4_build = {"ptxas": {k: v for k, v in ptxas_entries(reports["bilinear"]).items()
                          if "adjoint" in k},
                "sass_atomics": sass_atomics(_build.library_path("bilinear"), "adjoint")}
    if parent_tiled is not None:
        k4_build["tiled_ptxas"] = {k: v for k, v in ptxas_entries(
            reports["bilinear_tiled_parent"]).items() if "adjoint" in k}
    # the planned body: 32-bit shared atomics (its cell counts), none of f64
    planned = {f: ops for f, ops in k4_build["sass_atomics"].items() if "planned" in f}
    assert len(planned) == 2 and not any("64" in op or "CAS" in op
                                         for ops in planned.values() for op in ops), planned
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
    kern = phase_kernels(torch, dev, parent, parent_k2)
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

    # ---- the bench block over several devices (bands) ------------------------
    phase_multi_device(torch, cfg_dict, out)

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
    main_k2 = [k2_main_path(torch, dev, "bench_group_1", bench_cap.plan, floor_ms, parent_k2),
               k2_main_path(torch, dev, "production_group", prod_cap.plan, floor_ms, parent_k2)]
    # K2<8> at production shape: the production group's rows launched as G4460
    prod_k2_g4460 = k2_main_path(torch, dev, "production_group", prod_cap.plan, floor_ms,
                                 parent_k2, kern="G4460")
    del bench_cap.plan, prod_cap.plan
    for rec in main_k2 + [prod_k2_g4460]:
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
    g_k1, g_k2 = phase_g4460_kernels(torch, dev, k1_caps, g4460_plan, floor_ms, parent_k2)
    del g4460_plan
    assert not k1_caps, sorted(k1_caps)
    wing, wing_launches, wing_err = phase_wing_canvas_production(torch, dev, floor_ms)
    torch.cuda.empty_cache()

    # ---- 11b. Piff PSF files drawn on the card --------------------------------
    piff_launches, piff_k1, piff_k2, piff_k2_8 = phase_piff_block(
        torch, dev, cfg_dict, {"block_s": t_block, "SL1": SL1, "uc_median": uc_med},
        floor_ms, parent, parent_k2)
    torch.cuda.empty_cache()

    # ---- 12. destriping, from imdestripe.main to the coadd ------------------------
    k3, k4, plan64, ds_launches, (k3_32, k4_32, plan32, f32_launches) = phase_destripe(
        torch, dev, floor_ms, parent_k4, k4_build, parent_tiled)
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
    # the G4460 forms: launches of the G4460 bench block, the wing
    # subtraction task and the production wing canvases; K1's time is the
    # G4460 block's PSF sampling (the production block's canvas launch
    # beside it), K2's its first group's
    k1g = line("interp_g4460_dense", src, "pyimcom_tpu/ops/interp.py:357",
               g4460_launches["interp_g4460_dense"] + task_launches["interp_g4460_dense"]
               + wing_launches,
               max([r["max_abs_err"] for r in g_k1.values()] + [wing_err]),
               g_k1["g4460/psf_sampling"], no_lib)
    pb = wing["production_block_0"]
    k1g.update(production_block_ms=pb["ms"], production_block_runs_ms=pb["runs_ms"],
               production_block_bound_ms=pb["roofline_ms"],
               production_block_smem_bound_ms=pb["smem_bound_ms"])
    summary.append(k1g)
    # (its errors those of the production group's rows launched as G4460 and
    # of the launches at 8x of the Piff phase too)
    k2g = {one["mode"]: one for one in g_k2["launches"]}
    for mode in ("pool", "B"):
        summary.append(line(f"sweep_g4460_scatter.{mode}", src,
                            "pyimcom_tpu/ops/interp.py:386",
                            g4460_launches[f"sweep_g4460_scatter.{mode}"],
                            max(one["max_abs_err"]
                                for rec in [g_k2, prod_k2_g4460] + piff_k2_8
                                for one in rec["launches"]
                                if one["mode"] == mode), k2g[mode], no_lib))
    bil = "pyimcom_tpu_torch/csrc/bilinear.cu"
    summary.append(line("bilinear_gather", bil, "pyimcom_tpu/ops/bilinear.py:45",
                        ds_launches["bilinear_gather"], k3["max_abs_err"], k3, k3["library_ms"]))
    summary.append(line("bilinear_scatter_adjoint", bil, "pyimcom_tpu/ops/bilinear.py:61",
                        ds_launches["bilinear_scatter_adjoint"], k4["max_abs_err"], k4,
                        k4["library_ms"]))
    # the float32-position forms: launches of the destripe_storage phase's
    # float32 routes, times on the first pair of its on-card float32 maps
    summary.append(line("bilinear_gather.f32", bil, "pyimcom_tpu/ops/bilinear.py:45",
                        f32_launches["bilinear_gather.f32"], k3_32["max_abs_err"], k3_32,
                        k3_32["library_ms"]))
    summary.append(line("bilinear_scatter_adjoint.f32", bil, "pyimcom_tpu/ops/bilinear.py:61",
                        f32_launches["bilinear_scatter_adjoint.f32"], k4_32["max_abs_err"],
                        k4_32, k4_32["library_ms"]))
    # the plan kernel: launches of the destripe main path (f64 maps) and of
    # the storage phase's float32 routes' cost builds, times on the first pair
    summary.append(line("bilinear_adjoint_plan", bil, "pyimcom_tpu/ops/bilinear.py:61",
                        ds_launches["bilinear_adjoint_plan"], plan64["max_abs_err"], plan64,
                        None))
    summary.append(line("bilinear_adjoint_plan.f32", bil, "pyimcom_tpu/ops/bilinear.py:61",
                        f32_launches["bilinear_adjoint_plan.f32"], plan32["max_abs_err"],
                        plan32, None))
    summary.append(line("probe_add_one", "pyimcom_tpu_torch/csrc/probe.cu",
                        "scripts/probe_pallas.py:33", probe_launches,
                        kern["probe"]["max_abs_err"], kern["probe"],
                        kern["probe"]["library_ms"]))
    # every kernel of the main path was launched there
    assert all(k["launches"] > 0 for k in summary), summary
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
