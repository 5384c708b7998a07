#!/usr/bin/env python3
"""
Time the destriping adjoint kernel K4 (pyimcom_tpu_torch/csrc/bilinear.cu)
against ablations of its design, on one CUDA GPU.

    python3 k4_variants.py [--rolls 0 15 30 45 60 90] [--reps 15] [--first-pair]

The planned body is timed as it is and with one part of its design undone:

- ``kept``: the source as it is, over the pair's plan
  (``bilinear_cuda.build_adjoint_plan``);
- ``box_window``: the same kernel over a plan whose bands all take their
  tile's bounding box of columns (a bounding-box window, no per-band
  spans: it stages r times the contributing queries, r printed beside);
- source variants, each built with nvcc beside the kept source (all builds
  started together) and called through the same C entry:
  ``three_blocks`` (the registers fitted to three blocks an SM, not four),
  ``chunk_1536`` (a larger staging buffer),
  ``cell_pitch_33`` / ``gain_pitch_34`` (the cells' counts at a row pitch
  of 33, not 38, and the gain window at 34 doubles, not 36), and parts of
  the body left out to time them: ``no_sort`` (right sums, in no fixed
  order), ``no_pixel_sums`` and ``loads_only`` (wrong sums: no pixel pass;
  nothing but the plan, the copies and the stores);
- ``no_plan``: the tiled body, the library's off-plan entry on the same 2-D
  grid (32 x 32 query tiles, shared-memory boxes flushed with f64 atomics
  into an output the caller zeroes; the zero fill is timed with it).

The inputs are 4088^2 pair-like query grids (the target's pixels rolled by
each angle about the centre and shifted, ~85 % of them on a 4088^2 image;
with ``--first-pair`` also the destripe phase's first pair as chip_smoke.py
builds it, ~2 minutes of host work), random values and a gain in [0.5, 2]
made from a seed on the card (the pair's own gain for the first pair),
with positions in float64 and rounded to float32 (each kernel's two forms).
Each time is the median of ``--reps`` device times behind a sleep
(chip_smoke's device_times), every variant timed in turns; each result
that computes the adjoint is held to the plain version (1e-12 of scale)
and each planned one to a second launch, bit for bit.  One JSON line per
case and form, after the card's name and power limit: the map's steps at
the centre, the plan's r, bytes and build time (the plan kernel, and its
plain version in torch, which must give the same plan), the tiles' staged
queries
(quantiles, chunks), and every variant's time.  Beside them the plan
kernel against ablations of its one pass, timed in turns
(``plan_kept``; ``plan_every_run_end``: an atomic at every run's start
and end, as before the neighbouring runs of a tile were merged;
``plan_no_row_atomics`` and ``plan_no_atomics``: wrong plans, the pass
without its tiles' row atomics, without any; ``plan_segments_128``:
warps of 128 queries, not 256; ``plan_ring_128``: a tile's ring of 128
rows, not 256).  Exits 2 without a CUDA GPU.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
OUT = REPO / ".k4_variants"           # git-ignored build directory

VARIANTS = {
    "kept": [],
    "three_blocks": [("constexpr int kMinBlocks = 4;", "constexpr int kMinBlocks = 3;"),
                     ("constexpr int kChunk = 1280;", "constexpr int kChunk = 1536;")],
    "chunk_1536": [("constexpr int kChunk = 1280;", "constexpr int kChunk = 1536;")],
    "cell_pitch_33": [("constexpr int kCellPitch = 38;", "constexpr int kCellPitch = 33;")],
    "gain_pitch_34": [("constexpr int kGainPitch = 36;", "constexpr int kGainPitch = 34;")],
    "no_sort": [("    for (int a = lo + 1; a < hi; ++a) {",
                 "    for (int a = lo + 1; a < hi && a < 0; ++a) {")],
    "no_pixel_sums": [("      for (int e = start[cc]; e < hi; ++e) {",
                       "      for (int e = start[cc]; e < hi && e < 0; ++e) {")],
    "loads_only": [("    if (cur.n > 0) compute<Pos>(", "    if (cur.n < 0) compute<Pos>(")],
}
# variants that do not compute the adjoint (they time a part of the body)
WRONG = ("no_pixel_sums", "loads_only")
# ablations of the plan kernel (bilinear_adjoint_plan), each a copy of the
# source built beside the others and timed through the same C entry; those
# marked wrong give another plan (they time a part of the pass)
_ROW = "          atomicMin(lo + tk, qr);\n          atomicMax(hi + tk, qr);\n"
_RING = ("          atomicMin(ring_lo + tk * kRing + rr, c);\n",
         "        if (end) atomicMax(ring_hi + tk * kRing + rr, c);\n")
PLAN_VARIANTS = {
    "plan_kept": [],
    "plan_every_run_end": [
        ("const bool start = tk != left[k] && !(k < 2 && left[k < 2 ? k + 2 : k] == tk);",
         "const bool start = tk != left[k];"),
        ("const bool end = tk != right[k] && !(k >= 2 && right[k >= 2 ? k - 2 : k] == tk);",
         "const bool end = tk != right[k];")],
    "plan_no_row_atomics": [(_ROW, "")],
    "plan_no_atomics": [(_ROW, ""), (_RING[0], ""), (_RING[1], "")],
    "plan_segments_128": [("constexpr int kPlanSegQ = 256;", "constexpr int kPlanSegQ = 128;")],
    "plan_ring_128": [("constexpr int kRing = 256;", "constexpr int kRing = 128;")],
}
PLAN_WRONG = ("plan_no_row_atomics", "plan_no_atomics")


def source(name):
    s = (REPO / "pyimcom_tpu_torch" / "csrc" / "bilinear.cu").read_text()
    for old, new in {**VARIANTS, **PLAN_VARIANTS}[name]:
        if old not in s:
            raise RuntimeError(f"variant {name}: the source no longer holds {old!r}")
        s = s.replace(old, new)
    return s


def build(name):
    from pyimcom_tpu_torch import _build
    from pyimcom_tpu_torch.ops import bilinear_cuda as bc

    src, lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    src.write_text(source(name))
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stderr}")
    dll = ctypes.CDLL(str(lib))
    fns = {}
    for entry in ("bilinear_scatter_adjoint", "bilinear_scatter_adjoint_f32",
                  "bilinear_scatter_adjoint_stream", "bilinear_scatter_adjoint_stream_f32",
                  "bilinear_adjoint_plan", "bilinear_adjoint_plan_f32"):
        fn = getattr(dll, entry)
        fn.argtypes, fn.restype = bc._SIGNATURES[entry], ctypes.c_int
        fns[entry] = fn
    return name, fns


def box_plan(plan):
    """`plan` with every band of a tile spanning the tile's bounding box of
    columns (its window counted again)."""
    import dataclasses

    import torch

    T = plan.ptr.numel() - 1
    nb = (plan.ptr[1:] - plan.ptr[:-1]).long()
    tile = torch.repeat_interleave(torch.arange(T, device=nb.device), nb)
    s = plan.spans.long() & 0xFFFFFFFF
    lo, hi = s & 0xFFFF, s >> 16
    empty = lo > hi
    big = torch.iinfo(torch.int64).max
    t_lo = torch.full((T,), big, dtype=torch.int64, device=nb.device)
    t_hi = torch.full((T,), -1, dtype=torch.int64, device=nb.device)
    t_lo.scatter_reduce_(0, tile, torch.where(empty, big, lo), "amin")
    t_hi.scatter_reduce_(0, tile, torch.where(empty, -1, hi), "amax")
    packed = t_lo[tile] | (t_hi[tile] << 16)
    spans = torch.where(packed >= 2 ** 31, packed - 2 ** 32, packed).to(torch.int32)
    meta = plan.check().meta.clone()
    box = dataclasses.replace(plan, spans=spans.contiguous(), meta=meta)
    meta[2] = int(box.tile_windows().sum())
    return box


def plan_variants(torch, cs, bc, libs, x, y, plan, reps):
    """Each plan-kernel variant's build of the plan of x, y (a square grid on
    a square output of the same side), into buffers sized as
    build_adjoint_plan sizes them, timed in turns: `<variant>_ms`, and
    whether it gives `plan` word for word (`<variant>_equal`; the
    variants in PLAN_WRONG do not)."""
    n = x.shape[0]
    T = (-(-n // bc.PLAN_TILE)) ** 2
    dev = x.device
    i32 = dict(dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sfx = "_f32" if x.dtype == torch.float32 else ""
    rec, calls = {}, {}
    for name, fns in libs.items():
        ring = 128 if name == "plan_ring_128" else bc.PLAN_RING_ROWS
        bufs = dict(rows=torch.empty((T, 2), **i32), ptr=torch.empty(T + 1, **i32),
                    spans=torch.empty(T * -(-min(n, ring) // bc.PLAN_BAND), **i32),
                    meta=torch.empty(4, dtype=torch.int64, device=dev),
                    scratch=torch.empty(2 * (T * (ring + 1) + T // bc.PLAN_SCAN_TILES + 1),
                                        **i32))

        def call(fn=fns["bilinear_adjoint_plan" + sfx], b=bufs, name=name):
            err = fn(x.data_ptr(), y.data_ptr(), n, n, n, n, b["scratch"].data_ptr(),
                     b["rows"].data_ptr(), b["ptr"].data_ptr(), b["spans"].data_ptr(),
                     b["meta"].data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"variant {name}: cudaError {err}")
        call()
        torch.cuda.synchronize()
        bands = int(bufs["meta"][1])
        rec[f"{name}_equal"] = bool(bufs["rows"].equal(plan.rows) and bufs["ptr"].equal(plan.ptr)
                                    and bufs["spans"][:bands].equal(plan.spans))
        if name not in PLAN_WRONG and not rec[f"{name}_equal"]:
            raise RuntimeError(f"variant {name} gives another plan")
        calls[name] = call
    rec.update({f"{k}_ms": t for k, t in cs.in_turns(torch, calls, 2 * reps).items()})
    return rec


def first_pair(torch, dev):
    """The destripe phase's first pair as chip_smoke.py builds it (3 striped
    F184 SCAs at 4088^2, imdestripe.main for one CG iteration): its
    positions (float64), the neighbour's gain and the target's shape."""
    import shutil

    import chip_smoke as cs
    from pyimcom_tpu_torch import imdestripe
    from pyimcom_tpu_torch.config import Config

    root = OUT / "destripe"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cfg_dict, _raw = cs.striped_survey(root)
    d = dict(cfg_dict, DSOUT=[str(root / "ds"), "ds"],
             DSOBSFILE=str(root / "in" / "sim_L2_*[0-9].fits"))
    with cs.capture_destripe() as cap:
        imdestripe.main(Config(d), maxiter=1)
    dc = cap.problem.device_cost
    _i, j = dc.pairs[0]
    return dc.xf[0].clone(), dc.yf[0].clone(), dc.ge[j].clone(), (dc.ny, dc.nx)


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--rolls", type=float, nargs="+", default=[0, 15, 30, 45, 60, 90])
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--first-pair", action="store_true",
                    help="also time the destripe phase's first pair (builds its survey: "
                         "~2 min of host work)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_variants: no CUDA GPU available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(REPO), str(REPO / "tests")]
    import chip_smoke as cs
    from pyimcom_tpu_torch.ops import bilinear, bilinear_cuda as bc

    OUT.mkdir(exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS) + len(PLAN_VARIANTS)) as pool:
        libs = dict(pool.map(build, [*VARIANTS, *PLAN_VARIANTS]))
    plan_libs = {k: libs.pop(k) for k in PLAN_VARIANTS}
    print(cs.gpu_name_and_power(), flush=True)
    dev = torch.device("cuda", 0)
    n = 4088
    gen = torch.Generator(device=dev).manual_seed(20261017)
    gain_syn = 0.5 + 1.5 * torch.rand((n, n), generator=gen, dtype=torch.float64, device=dev)
    v = torch.randn((n, n), generator=gen, dtype=torch.float64, device=dev)
    yy, xx = torch.meshgrid(torch.arange(n, dtype=torch.float64, device=dev) - n / 2,
                            torch.arange(n, dtype=torch.float64, device=dev) - n / 2,
                            indexing="ij")
    cases = []
    for roll in args.rolls:
        th = np.deg2rad(roll)
        cases.append((f"roll {roll:g}", gain_syn,
                      (np.cos(th) * xx - np.sin(th) * yy + n / 2 + 300.3).contiguous(),
                      (np.sin(th) * xx + np.cos(th) * yy + n / 2 - 200.7).contiguous()))
    del xx, yy
    if args.first_pair:
        x, y, g, shape = first_pair(torch, dev)
        assert shape == (n, n) and x.shape == (n, n), (shape, x.shape)
        cases.append(("destripe first pair", g, x, y))
    out = torch.empty((n, n), dtype=torch.float64, device=dev)
    again = torch.empty_like(out)
    counter = torch.zeros(1, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for case, gain, x64, y64 in cases:
        for form, (x, y) in (("f64", (x64, y64)), ("f32", (x64.float(), y64.float()))):
            sfx = "_f32" if form == "f32" else ""
            plan = bc.build_adjoint_plan(x, y, (n, n))
            box = box_plan(plan)
            want = bilinear.bilinear_scatter_adjoint_plain(v, x, y, (n, n), gain)
            windows = plan.tile_windows()
            chunks = torch.clamp(-(-windows // bc.PLAN_CHUNK), min=1)
            staging = windows[windows > 0].double()
            c = n // 2
            rec = {"case": case, "positions": form, "queries": n * n,
                   # the map's steps at the grid's centre: a column, a row
                   "map_step_column": [float(x64[c, c + 1] - x64[c, c]),
                                       float(y64[c, c + 1] - y64[c, c])],
                   "map_step_row": [float(x64[c + 1, c] - x64[c, c]),
                                    float(y64[c + 1, c] - y64[c, c])],
                   "in_bounds": int(bilinear.in_bounds(x, y, (n, n)).sum()),
                   "plan_r": plan.r, "plan_bytes": plan.nbytes,
                   "plan_build_ms": cs.median_ms(
                       torch, lambda x=x, y=y: bc.build_adjoint_plan(x, y, (n, n)), 3),
                   "plan_build_plain_ms": cs.median_ms(
                       torch, lambda x=x, y=y: bc.build_adjoint_plan_plain(x, y, (n, n)), 1),
                   "plan_equals_plain": cs.same_plan(
                       plan, bc.build_adjoint_plan_plain(x, y, (n, n))),
                   "box_window_r": box.r, "tiles_staging": staging.numel(),
                   "tile_window_quantiles_10_50_90_99": torch.quantile(
                       staging, torch.tensor([0.1, 0.5, 0.9, 0.99], dtype=torch.float64,
                                             device=dev)).tolist(),
                   "tiles_by_chunks": {int(k): int(c) for k, c in zip(*torch.unique(
                       chunks, return_counts=True))},
                   "zero_fill_ms": cs.median_ms(torch, out.zero_, args.reps)}
            rec.update(plan_variants(torch, cs, bc, plan_libs, x, y, plan, args.reps))
            calls = {}
            for name, fns in libs.items():
                for pname, p in (("", plan), ("box_window", box)):
                    if pname and name != "kept":
                        continue
                    key = pname or name

                    def call(fn=fns["bilinear_scatter_adjoint" + sfx], p=p, dst=out, key=key):
                        err = fn(v.data_ptr(), gain.data_ptr(), n, n, x.data_ptr(),
                                 y.data_ptr(), n, n, p.rows.data_ptr(), p.ptr.data_ptr(),
                                 p.spans.data_ptr(), dst.data_ptr(), 0, stream)
                        if err != 0:
                            raise RuntimeError(f"variant {key}: cudaError {err}")
                    calls[key] = call

            def no_plan(fn=libs["kept"]["bilinear_scatter_adjoint_stream" + sfx]):
                out.zero_()
                err = fn(v.data_ptr(), gain.data_ptr(), n, n, x.data_ptr(), y.data_ptr(), n, n,
                         out.data_ptr(), counter.data_ptr(), stream)
                if err != 0:
                    raise RuntimeError(f"variant no_plan: cudaError {err}")
            calls["no_plan"] = no_plan
            for key, call in calls.items():
                call()
                torch.cuda.synchronize()
                rec[f"{key}_max_abs_err"] = cs.rel_err(torch, out, want)
                if key in WRONG:
                    continue
                if not rec[f"{key}_max_abs_err"] < cs.TOL:
                    raise RuntimeError(f"variant {key} disagrees with the plain version: {rec}")
                if key != "no_plan":
                    again.copy_(out)
                    call()
                    torch.cuda.synchronize()
                    rec[f"{key}_repeat_bit_identical"] = bool(torch.equal(out, again))
            # in turns: each variant, then each again in reverse order
            times = {key: [] for key in calls}
            for order in (list(calls), list(reversed(calls))):
                for key in order:
                    times[key] += cs.device_times(torch, calls[key], args.reps)
            for key, ts in times.items():
                rec[f"{key}_ms"] = float(np.median(ts))
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
