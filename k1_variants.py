#!/usr/bin/env python3
"""
Time K1<8>'s canvas body (pyimcom_tpu_torch/csrc/interp_d5512.cu,
interp_canvas_kernel) against ablations of its design on the production
wing canvas, on one CUDA GPU.

    python3 k1_variants.py [--rolls 0 45 90] [--reps 20]

The inputs are chip_smoke.py's production block (wing_queries: the
12324^2 canvas of a 4088^2 SCA at oversampling 3 mapped into a mosaic
block of 2560^2 at 0.0390625" padded to 2572^2, rolled by each angle; a
seeded image on the card).  The body is timed as it is (``kept``), with
one part of its design changed -- ``three_blocks`` / ``two_blocks`` (3 or
2 CTAs an SM, 72 KB of shared memory each, more registers),
``compute_not_unrolled`` (the tile's queries one at a time) -- and with a
part left out to time the rest: ``no_stage`` (every patch read through L1
/ L2 in the tile's layout) and ``no_compute`` (the segments, positions,
window and its staging, and a store a query: wrong values); beside it the
body of runs of 32 queries (``runs``, no hint).  Each variant is a copy of
the source built with nvcc beside the others (all builds started
together) and called through the same C entry; each that computes is held
to the runs body bit for bit.  Times are medians of --reps device times
behind a sleep (chip_smoke's device_times), every variant in turns.  One
JSON line per roll after the card's name and power limit, with each
variant's ptxas registers and spills.  Exits 2 without a CUDA GPU.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
OUT = REPO / ".k4_variants" / "k1"           # git-ignored build directory

_BLOCKS = "constexpr int kCanvasMinBlocks = 4;\nconstexpr int kCanvasSmem = 57344;"
VARIANTS = {
    "kept": [],
    "three_blocks": [(_BLOCKS, "constexpr int kCanvasMinBlocks = 3;\n"
                               "constexpr int kCanvasSmem = 73728;")],
    "two_blocks": [(_BLOCKS, "constexpr int kCanvasMinBlocks = 2;\n"
                             "constexpr int kCanvasSmem = 73728;")],
    "compute_not_unrolled": [
        ("#pragma unroll\n  for (int i = 0; i < kCanvasPer; ++i) {\n"
         "    if (q[i] < 0) continue;",
         "#pragma unroll 1\n  for (int i = 0; i < kCanvasPer; ++i) {\n"
         "    if (q[i] < 0) continue;")],
    "no_stage": [("  const bool stage = (reinterpret_cast<uintptr_t>(images) & 15) == 0;",
                  "  const bool stage = false;")],
    "no_compute": [("    out[q[i]] = canvas_value<TAPS>(sx[slot], sy[slot], staged ? win : "
                    "nullptr, w, img, ny, nx,\n                                   pairs);",
                    "    out[q[i]] = sx[slot] + (staged ? win[0] : 0.0);")],
}
WRONG = ("no_compute",)


def build(name):
    from pyimcom_tpu_torch import _build

    s = (REPO / "pyimcom_tpu_torch" / "csrc" / "interp_d5512.cu").read_text()
    for old, new in VARIANTS[name]:
        if old not in s:
            raise RuntimeError(f"variant {name}: the source no longer holds {old!r}")
        s = s.replace(old, new)
    src, lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    src.write_text(s)
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stderr}")
    return name, lib, proc.stdout + proc.stderr


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--rolls", type=float, nargs="+", default=[0, 45, 90])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_variants: no CUDA GPU available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(REPO), str(REPO / "tests")]
    import chip_smoke as cs
    from pyimcom_tpu_torch.ops import interp_cuda as ic

    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(build, VARIANTS))
    fns, regs = {}, {}
    for name, lib, report in built:
        fn = getattr(ctypes.CDLL(str(lib)), "interp_g4460_dense_canvas")
        fn.argtypes, fn.restype = ic._SIGNATURES["interp_g4460_dense_canvas"], ctypes.c_int
        fns[name] = fn
        regs[name] = {k: v for k, v in cs.ptxas_entries(report).items()
                      if "canvas_kernelILi8" in k}
    print(cs.gpu_name_and_power(), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(20261018)
    side = cs.WING_N + 2 * cs.WING_PAD
    img = torch.randn((1, side, side), generator=gen, dtype=torch.float64, device=dev)
    centre = (3 * cs.WING_N + 1021.3, 3 * cs.WING_N + 733.7)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for roll in args.rolls:
        x, y, hint = cs.wing_queries(torch, dev, roll, (3 * cs.WING_N, 3 * cs.WING_N),
                                     cs.WING_N, centre)
        seg, tiles = hint.tables(dev, x.shape[1])
        out = torch.empty_like(x)
        want = ic.interp_dense(img, x, y, "G4460")
        calls, rec = {}, {"roll": roll, "queries": x.shape[1], "tiles": len(hint.tiles),
                          "ptxas": regs}
        for name, fn in fns.items():
            def call(fn=fn, name=name):
                err = fn(img.data_ptr(), side, side, x.data_ptr(), y.data_ptr(), seg.data_ptr(),
                         tiles.data_ptr(), len(tiles), int(hint.transpose), out.data_ptr(),
                         stream)
                if err != 0:
                    raise RuntimeError(f"variant {name}: cudaError {err}")
            call()
            torch.cuda.synchronize()
            if name not in WRONG and not torch.equal(out, want):
                raise RuntimeError(f"variant {name} differs from the runs body")
            calls[name] = call
        calls["runs"] = lambda: ic.interp_dense(img, x, y, "G4460")
        rec.update({f"{k}_ms": t for k, t in cs.in_turns(torch, calls, args.reps).items()})
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
