#!/usr/bin/env python3
"""
Time the destriping adjoint kernel K4 (pyimcom_tpu_torch/csrc/bilinear.cu)
against ablations of its design, on one CUDA GPU.

    python3 k4_variants.py [--rolls 0 15 30 45 60 90] [--reps 15]

Each variant is the source with one part of the design undone by a text
replacement, built with nvcc beside the others (all builds started
together) and called through the same C entry:

- ``kept``: the source as it is;
- ``odd_pitch``: the box's row pitch bw | 1, not 12 (mod 16);
- ``line_warps``: each warp takes a run of 32 queries of a tile row, not an
  8 x 4 block;
- ``global_only``: every tile on the global route (four f64 atomicAdds a
  query into device memory, as the one-thread-a-query form);
- ``plain_shared_adds``: the shared-memory adds without atomics (wrong
  sums: it times what the atomics cost);
- ``no_flush``: the box is never flushed (wrong: it times the flush);
- ``loads_only``: each tile stops after its bounding box (wrong: it times
  reading the queries).

The inputs are a 4088^2 pair-like query grid (the target's pixels rolled by
each angle about the centre and shifted, ~85 % of them on a 4088^2 image),
random values and a gain in [0.5, 2], made from a seed on the card.  Each
time is the median of ``--reps`` device times behind a sleep (chip_smoke's
device_times), the output's zero fill included, as the wrapper has it; the
zero fill alone and, for the variants that compute the right sums, the
error against the plain version are printed beside.  One JSON line per
roll, after the card's name and power limit and a line of bank_pairs(): the
most words of one warp's taps on a bank pair, by warp layout and pitch
rule, at every roll.  Exits 2 without a CUDA GPU.
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

FLUSH = "if (a != 0.0) atomicAdd(out + (y_lo + r) * nx + x_lo + c, a);"
VARIANTS = {
    "kept": [],
    "odd_pitch": [("int pitch = bw + ((12 - bw) & 15);", "int pitch = bw | 1;")],
    "line_warps": [
        ("const int qr = TILE_W == 32 ? r0 + (f >> 7) * 4 + (lane >> 3) : r0;",
         "const int qr = r0 + f / TILE_W;"),
        ("const int qc = TILE_W == 32 ? c0 + ((f >> 5) & 3) * 8 + (lane & 7) : c0 + f;",
         "const int qc = c0 + f % TILE_W;")],
    "global_only": [("if (static_cast<long long>(bw) * bh > kBoxCap) {", "if (true) {")],
    "plain_shared_adds": [("atomicAdd(acc + s, vv * w[0]);", "acc[s] += vv * w[0];"),
                          ("atomicAdd(acc + s + 1, vv * w[1]);", "acc[s + 1] += vv * w[1];"),
                          ("atomicAdd(acc + s + pitch, vv * w[2]);",
                           "acc[s + pitch] += vv * w[2];"),
                          ("atomicAdd(acc + s + pitch + 1, vv * w[3]);",
                           "acc[s + pitch + 1] += vv * w[3];")],
    "no_flush": [(FLUSH, "if (a == -1.5) out[(y_lo + r) * nx + x_lo + c] = a;")],
    "loads_only": [("  if (x_lo > x_hi) return;  // no query of the tile is in bounds",
                    "  if (x_lo <= x_hi && x_hi < 0) out[0] = v[0] + v[1] + v[2] + v[3];\n"
                    "  return;")],
}
WRONG = ("plain_shared_adds", "no_flush", "loads_only")


def bank_pairs(rolls=np.arange(0.0, 180.0, 1.0), bw=46, seed=0, trials=20):
    """The most distinct 8-byte words of one warp's taps that share a bank
    pair (word % 16), over `rolls` (degrees) and random sub-pixel offsets,
    for each warp layout (a run of 32, an 8 x 4 block) and box pitch rule
    (bw | 1, 12 mod 16), at a 46-pixel-wide box; 2 is the least for 32
    words.  Computed on the host: no card is needed."""
    rng = np.random.default_rng(seed)
    lane = np.arange(32)
    layouts = {"run_of_32": (0 * lane, lane), "block_8x4": (lane // 8, lane % 8)}
    pitches = {"odd": bw | 1, "12_mod_16": bw + ((12 - bw) & 15)}
    out = {}
    for lname, (r, c) in layouts.items():
        for pname, pitch in pitches.items():
            worst = 0
            for roll in np.deg2rad(rolls):
                for x0, y0 in rng.uniform(0, 1, (trials, 2)):
                    ix = np.floor(np.cos(roll) * c - np.sin(roll) * r + x0 + 8).astype(int)
                    iy = np.floor(np.sin(roll) * c + np.cos(roll) * r + y0 + 8).astype(int)
                    words = np.unique(iy * pitch + ix)
                    worst = max(worst, int(np.bincount(words % 16).max()))
            out[f"{lname}/{pname}"] = worst
    return out


def source(name):
    s = (REPO / "pyimcom_tpu_torch" / "csrc" / "bilinear.cu").read_text()
    for old, new in VARIANTS[name]:
        if old not in s:
            raise RuntimeError(f"variant {name}: the source no longer holds {old!r}")
        s = s.replace(old, new)
    return s


def build(name):
    from pyimcom_tpu_torch import _build

    src, lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    src.write_text(source(name))
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stderr}")
    fn = ctypes.CDLL(str(lib)).bilinear_scatter_adjoint
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = (p, p, i, i, p, p, i, i, p, p, p)
    fn.restype = ctypes.c_int
    return name, fn


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--rolls", type=float, nargs="+", default=[0, 15, 30, 45, 60, 90])
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_variants: no CUDA GPU available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(REPO)]
    import chip_smoke as cs
    from pyimcom_tpu_torch.ops import bilinear

    OUT.mkdir(exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        fns = dict(pool.map(build, VARIANTS))
    print(cs.gpu_name_and_power(), flush=True)
    print(json.dumps({"bank_pairs_max_words": bank_pairs()}), flush=True)
    dev = torch.device("cuda", 0)
    n = 4088
    gen = torch.Generator(device=dev).manual_seed(20261017)
    gain = 0.5 + 1.5 * torch.rand((n, n), generator=gen, dtype=torch.float64, device=dev)
    v = torch.randn((n, n), generator=gen, dtype=torch.float64, device=dev)
    yy, xx = torch.meshgrid(torch.arange(n, dtype=torch.float64, device=dev) - n / 2,
                            torch.arange(n, dtype=torch.float64, device=dev) - n / 2,
                            indexing="ij")
    out = torch.empty((n, n), dtype=torch.float64, device=dev)
    counter = torch.zeros(1, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for roll in args.rolls:
        th = np.deg2rad(roll)
        x = (np.cos(th) * xx - np.sin(th) * yy + n / 2 + 300.3).contiguous()
        y = (np.sin(th) * xx + np.cos(th) * yy + n / 2 - 200.7).contiguous()
        want = bilinear.bilinear_scatter_adjoint_plain(v, x, y, (n, n), gain)
        rec = {"roll_deg": roll, "queries": n * n,
               "in_bounds": int(bilinear.in_bounds(x, y, (n, n)).sum()),
               "zero_fill_ms": cs.median_ms(torch, out.zero_, args.reps)}
        for name, fn in fns.items():
            def call(fn=fn, name=name):
                out.zero_()
                err = fn(v.data_ptr(), gain.data_ptr(), n, n, x.data_ptr(), y.data_ptr(), n, n,
                         out.data_ptr(), counter.data_ptr(), stream)
                if err != 0:
                    raise RuntimeError(f"variant {name}: cudaError {err}")
            call()
            torch.cuda.synchronize()
            rec[f"{name}_ms"] = cs.median_ms(torch, call, args.reps)
            if name not in WRONG:
                rec[f"{name}_max_abs_err"] = cs.rel_err(torch, out, want)
                if not rec[f"{name}_max_abs_err"] < cs.TOL:
                    raise RuntimeError(f"variant {name} disagrees with the plain version: {rec}")
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
