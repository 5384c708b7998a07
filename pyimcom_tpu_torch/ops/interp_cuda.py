"""
The port's hand-written Hopper kernels for D5512 and G4460 interpolation,
their ctypes wrappers, and their plain PyTorch versions.

K1 ``interp_dense`` (launch count ``interp_d5512_dense``) replaces the JAX
package's TPU interpolation kernel (R images at R x Nq scattered points;
its dense contract is ``pyimcom_tpu.ops.interp.interp2d_dense``).  It serves the PSF resampling
and the star and galaxy injection, whose queries are lattices in row-major
order: a warp takes a run of 32 queries (8 x 4 neighbouring lattice points
where the caller gives the lattice's row length, else 32 consecutive
queries), a lane one query, and reads each patch row in 16-byte pairs
through L1 / L2.  Where the caller gives the canvas-row segments of its
queries (:class:`CanvasSegments`: the split-PSF wing canvas, whose points
are a lattice clipped to a block's footprint), K1 takes its canvas body
instead: a block a 32 x 32 tile of the lattice, its window of the image
staged in shared memory with bulk copies, each query read from there.

K2 ``sweep_scatter`` (``sweep_d5512_scatter.pool`` / ``.B``) replaces that
kernel's outer-difference-query variant, fused with the scatters of
``pyimcom_tpu/ops/assemble.py``'s
``sweep_pool_scan`` (mode 0, the submatrix pool) and ``sweep_b_scan``
(mode 1, -B/2): each query is formed from the f64 coordinate tables,
interpolated and added where it lands.  Pool tiles are walked by one
persistent block an SM, whose producer warps find each tile's window and
stage it into a two-slot ring with bulk copies while the other warps
compute the previous one in shared-memory bank order; a B tile is a run of
i1 of one row that shares one staged window.

Each has a G4460 form, the same template with an 8 x 8 patch, taken with
``kern="G4460"``: K1 ``interp_g4460_dense`` (the JAX package's XLA
``interp2d_dense(..., "G4460")``: the wing resample of split-PSF wing
subtraction and the PSF sampling of PSFINTERP "G4460" blocks) and K2
``sweep_g4460_scatter`` (the sweep of those blocks).

All live in ``csrc/interp_d5512.cu`` (its header names the TPU kernel
file and functions they replace, what bounds them on the card and what the
design does about it), built by ``nvcc`` at first use (``_build.py``).  A
wrapper takes CUDA tensors only and raises on anything else; it launches on
the current stream, allocates its outputs with torch, checks the launch,
and counts it in ``launches``.  The plain versions compute the same
function with a gather of the family's patches, two contractions and
``index_add_``; the CPU path uses them, and ``chip_smoke.py``
holds each kernel against its plain version on the card.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import _build
from . import interp as _interp

# the C entries of each family's K1 and K2
K1 = {"D5512": "interp_d5512_dense", "G4460": "interp_g4460_dense"}
K2 = {"D5512": "sweep_d5512_scatter", "G4460": "sweep_g4460_scatter"}

# launches of each kernel since the last reset_launch_counts(); incremented
# by the wrappers where they launch, and nowhere else (K2 by mode: its pool
# and B forms are two kernels)
launches = {name: 0 for kern in K1 for name in
            (K1[kern], f"{K2[kern]}.pool", f"{K2[kern]}.B")}
# K1's launches by body: runs of 32 queries, or tiles of a canvas lattice
# (the `segments` hint)
dense_routes = {"runs": 0, "canvas": 0}

_p, _i, _ll, _d = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
_K1_ARGS = (_p, _i, _i, _i, _p, _p, _ll, _i, _p, _p)
_K2_ARGS = (_p, _i, _p, _i, _i, _i, _p, _p, _i, _p, _p, _p, _p, _i, _d, _d, _i, _i, _i, _i,
            _p, _p)
_CANVAS_ARGS = (_p, _i, _i, _p, _p, _p, _p, _i, _i, _p, _p)
_SIGNATURES = {**{name: _K1_ARGS for name in K1.values()},
               **{name + "_canvas": _CANVAS_ARGS for name in K1.values()},
               **{name: _K2_ARGS for name in K2.values()}}


def reset_launch_counts() -> None:
    for counts in (launches, dense_routes):
        for k in counts:
            counts[k] = 0


def _cfunc(name: str):
    fn = getattr(_build.library("interp_d5512"), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, dtype, device, ndim: int) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(name: str, count: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _cfunc(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
    launches[count] += 1


# --------------------------------------------------------------------------
# K1: dense scattered-point interpolation
# --------------------------------------------------------------------------

# K1's canvas body: tiles of at most CANVAS_TILE_ROWS x CANVAS_TILE_COLS
# canvas points and CANVAS_TILE_SEGS segments, each with a window of at
# most CANVAS_WINDOW doubles staged (csrc/interp_d5512.cu, kCanvasRows,
# kCanvasCols, kCanvasSegs, kCanvasWindow)
CANVAS_TILE_ROWS, CANVAS_TILE_COLS, CANVAS_TILE_SEGS = 32, 32, 64
CANVAS_WINDOW = 4972


@dataclass(frozen=True)
class CanvasSegments:
    """
    The layout hint of K1's canvas body for queries that are points of a
    canvas lattice (host NumPy, int32): `segments` (S, 4), each a run of
    consecutive columns of one canvas row holding consecutive queries --
    [row, first column, first query, queries] -- in row and column order,
    the queries in the same order; `tiles` (T, 5), the body's tiles
    [first segment, segments, first row, first column, columns]
    (:func:`canvas_tiles`) for lattice points `step` image samples apart;
    `transpose`: the lattice's columns run closer to the image's rows than
    its rows do (a warp then takes points of a column, so that its patch
    reads fall along an image row).
    """

    segments: np.ndarray
    tiles: np.ndarray
    transpose: bool = False
    step: float = 1.0
    _on: dict = field(default_factory=dict, init=False, compare=False, repr=False)

    def tables(self, device: torch.device, nq: int):
        """The segments and tiles as int32 tensors on `device`, uploaded once
        a device (a block's geometry serves every layer), after checking
        once that they lay out `nq` queries (ValueError otherwise)."""
        got = self._on.get(device)
        if got is None or got[0] != nq:
            _check_segments(self, nq)
            got = self._on[device] = (nq, *(
                torch.as_tensor(np.ascontiguousarray(a, np.int32), device=device)
                for a in (self.segments, self.tiles)))
        return got[1:]


def lattice_segments(idx, width: int) -> np.ndarray:
    """The segments (S, 4) int32 [row, first column, first query, queries]
    of queries at the flat, strictly increasing indices `idx` of a lattice
    `width` points wide: a segment a run of consecutive columns of one row
    (a row of a convex footprint is one segment; a row the footprint
    crosses twice, two)."""
    idx = np.asarray(idx, np.int64).ravel()
    if idx.size == 0:
        return np.zeros((0, 4), np.int32)
    if np.any(np.diff(idx) <= 0):
        raise ValueError("lattice_segments needs strictly increasing indices")
    row, col = np.divmod(idx, int(width))
    first = np.flatnonzero(np.r_[True, (np.diff(row) != 0) | (np.diff(col) != 1)])
    count = np.diff(np.r_[first, idx.size])
    return np.stack([row[first], col[first], first, count], 1).astype(np.int32)


def canvas_shape(step: float) -> tuple[int, int]:
    """The (rows, columns) of K1's canvas tiles for lattice points `step`
    image samples apart: CANVAS_TILE_ROWS x CANVAS_TILE_COLS, the columns
    and then the rows halved (down to 8) while the window of such a tile
    at the worst roll -- sides of step (rows + columns) / sqrt(2) samples,
    the 8 taps, a row's pad and pitch -- would outgrow CANVAS_WINDOW."""
    rows, cols = CANVAS_TILE_ROWS, CANVAS_TILE_COLS

    def window(r, c):
        side = step * (r + c) / math.sqrt(2) + 10
        return side * (side + 16)

    while window(rows, cols) > CANVAS_WINDOW and max(rows, cols) > 8:
        if cols > 8:
            cols //= 2
        else:
            rows //= 2
    return rows, cols


def canvas_tiles(segments, step: float = 1.0) -> np.ndarray:
    """K1's canvas tiles (T, 5) int32 [first segment, segments, first row,
    first column, columns] of `segments` (:func:`lattice_segments`) on a
    lattice of points `step` image samples apart: the rows in bands of the
    tile rows of :func:`canvas_shape` from the first (halved while a band
    holds more than CANVAS_TILE_SEGS segments; a row holding more is cut
    into groups of that many), each band's columns in tiles of its columns
    from the band's first; tiles that hold no query are left out.  Every
    query falls in exactly one tile."""
    seg = np.asarray(segments, np.int64).reshape(-1, 4)
    rows, cols = canvas_shape(step)
    out = []

    def band(s0, s1, r0, nrows):
        if s1 <= s0:
            return
        if s1 - s0 > CANVAS_TILE_SEGS:
            if nrows > 1:
                h = nrows // 2
                sm = s0 + int(np.searchsorted(seg[s0:s1, 0], r0 + h))
                band(s0, sm, r0, h)
                band(sm, s1, r0 + h, nrows - h)
            else:
                for g in range(s0, s1, CANVAS_TILE_SEGS):
                    band(g, min(g + CANVAS_TILE_SEGS, s1), r0, 1)
            return
        lo = seg[s0:s1, 1]
        hi = lo + seg[s0:s1, 3]
        c0 = np.arange(lo.min(), hi.max(), cols)
        full = ((lo[None, :] < c0[:, None] + cols) & (hi[None, :] > c0[:, None])).any(1)
        for c in c0[full]:
            out.append((s0, s1 - s0, r0, int(c), cols))

    if len(seg):
        row = seg[:, 0]
        for r0 in range(int(row[0]), int(row[-1]) + 1, rows):
            s0, s1 = np.searchsorted(row, [r0, r0 + rows])
            if s1 > s0:
                band(int(s0), int(s1), r0, rows)
    return np.asarray(out, np.int32).reshape(-1, 5)


def canvas_segments(idx, width: int, x=None, y=None) -> CanvasSegments:
    """The canvas hint (:class:`CanvasSegments`) of queries at the flat,
    strictly increasing lattice indices `idx` of a lattice `width` wide;
    with their image positions `x`, `y` (host arrays in the same order), its
    orientation: transposed where a step along a lattice row moves further
    in the image's y than in its x."""
    seg = lattice_segments(idx, width)
    transpose, step = False, 1.0
    if x is not None and y is not None:
        run = seg[seg[:, 3] >= 2]
        if len(run):
            q = int(run[len(run) // 2, 2])
            dx, dy = abs(float(x[q + 1] - x[q])), abs(float(y[q + 1] - y[q]))
            transpose, step = bool(dy > dx), math.hypot(dx, dy)
    return CanvasSegments(seg, canvas_tiles(seg, step), transpose, step)


def _check_segments(hint: CanvasSegments, nq: int) -> None:
    seg = np.asarray(hint.segments)
    if seg.ndim != 2 or seg.shape[1] != 4 or np.asarray(hint.tiles).shape[1:] != (5,):
        raise ValueError("segments must be (S, 4) and tiles (T, 5)")
    count = seg[:, 3].astype(np.int64)
    if (np.any(count <= 0) or int(count.sum()) != nq
            or np.any(seg[:, 2] != np.cumsum(count) - count)
            or np.any(np.diff(seg[:, 0]) < 0)):
        raise ValueError(f"the segments do not lay out the {nq} queries once, in row "
                         f"order")


def interp_dense(images: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                 kern: str = "D5512", *, lattice_row: int = 0,
                 segments: CanvasSegments | None = None) -> torch.Tensor:
    """
    K1 of the family `kern`: images (R, ny, nx), x, y (R, Nq), f64 CUDA ->
    (R, Nq), 0 off-grid.

    A warp takes a run of 32 queries of one image: 32 consecutive ones, or,
    where the caller says that each image's queries are a lattice in
    row-major order with rows of `lattice_row` points (which must divide
    Nq), 8 x 4 neighbouring points of it.  Where the caller gives the
    queries' `segments` on a canvas lattice (:class:`CanvasSegments`; one
    image), the canvas body runs instead: a block a tile of the lattice,
    its window of the image staged in shared memory.  The result does not
    depend on the layout.
    """
    _interp.check_kern(kern)
    dev = images.device
    _check(images, "images", torch.float64, dev, 3)
    R, ny, nx = images.shape
    _check(x, "x", torch.float64, dev, 2)
    _check(y, "y", torch.float64, dev, 2)
    if x.shape[0] != R or y.shape != x.shape:
        raise ValueError(f"x, y must be (R={R}, Nq); got {tuple(x.shape)}, "
                         f"{tuple(y.shape)}")
    if lattice_row < 0 or (lattice_row > 0 and x.shape[1] % lattice_row):
        raise ValueError(f"lattice_row {lattice_row} does not divide Nq = {x.shape[1]}")
    if ny * nx >= 2 ** 31:
        raise ValueError("K1 indexes an image with int32: it must hold fewer than 2**31 "
                         "samples")
    if segments is not None:
        if R != 1 or lattice_row:
            raise ValueError("the canvas hint takes one image and no lattice_row")
        if x.shape[1] >= 2 ** 31:
            raise ValueError("the canvas body indexes the queries with int32")
        seg, tiles = segments.tables(dev, x.shape[1])
    out = torch.empty(x.shape, dtype=torch.float64, device=dev)
    if out.numel() == 0:
        return out
    if segments is not None:
        _launch(K1[kern] + "_canvas", K1[kern], dev, images.data_ptr(), ny, nx,
                x.data_ptr(), y.data_ptr(), seg.data_ptr(), tiles.data_ptr(), len(tiles),
                int(segments.transpose), out.data_ptr())
        dense_routes["canvas"] += 1
        return out
    _launch(K1[kern], K1[kern], dev, images.data_ptr(), R, ny, nx,
            x.data_ptr(), y.data_ptr(), x.shape[1], int(lattice_row), out.data_ptr())
    dense_routes["runs"] += 1
    return out


def interp_dense_plain(images: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                       kern: str = "D5512") -> torch.Tensor:
    """Plain version of K1 (same function, any device)."""
    R, Nq = x.shape
    which = torch.arange(R, device=images.device).repeat_interleave(Nq)
    return _interp.interp2d_stack(images, x.reshape(-1), y.reshape(-1),
                                  which, kern).reshape(R, Nq)


# --------------------------------------------------------------------------
# K2: fused sweep (query formation + interpolation + scatter-add)
# --------------------------------------------------------------------------

# the most queries of one pool tile, and the most i2 columns it spans (the
# kernel cuts a tile whose window outgrows its slot into pieces of fewer
# i1); the most i1 of one B tile, a run of one row
TILE_QUERIES = 1024
TILE_COLS = 32
B_RUN = 8
# doubles of one of K2's two pool window slots (csrc/interp_d5512.cu,
# kPoolSlot): a piece of a tile whose window outgrows it is halved
POOL_SLOT_DOUBLES = 12544
# shared memory a block may use on the card (sm_90)
_SMEM_LIMIT = 232448
_LATTICE_ERROR = ("the output coordinates of a B row are not an exact {n2f} x {n2f} "
                  "integer lattice inside the coordinate tables (or its w2 is not "
                  "n2f**2); K2's B mode needs one")


def sweep_tiles(imeta, mode: int, xt=None, yt=None, n2f: int = 0,
                min_tiles: int = 0) -> np.ndarray:
    """
    The tiles of K2's launch: (T, 5) int32 rows [row, u0, v0, nu, nv], one
    thread block each.  Tile t holds the queries f = u * w2 + v of its row
    with u0 <= u < u0 + nu and v0 <= v < v0 + nv, i.e. table entries
    i1 = i1_start + u and i2 = i2_start + v; every query of every row (f in
    [off, off + nval)) falls in exactly one tile, and rows with nval 0 get
    none.  Pool rows (mode 0) are cut into near-square tiles of at most
    TILE_QUERIES queries and TILE_COLS columns; a B row (mode 1) into runs
    of at most B_RUN consecutive i1, each spanning the whole output lattice
    (v0 0, nv w2; the kernel keeps each i1's own queries of the row),
    shortened (down to one i1) while the launch would have fewer than
    `min_tiles` tiles (:func:`b_min_tiles`: a launch with few i1 then still
    fills the card).  Host numpy: `imeta` (..., 5) rows [i1_start,
    i2_start, w2, off, nval].

    B tiles need the host coordinate tables `xt`, `yt` and the lattice's
    `n2f`: K2's B mode computes each row's output coordinates from the
    lattice at i2_start, so this raises ValueError unless the tables hold
    it (:func:`check_output_lattice`).
    """
    im = np.asarray(imeta, np.int64).reshape(-1, 5)
    if mode == 1:
        if xt is None or yt is None or n2f <= 0:
            raise ValueError("B tiles need the coordinate tables xt, yt and n2f")
        check_output_lattice(xt, yt, im, n2f)
    w2 = np.maximum(im[:, 2], 1)
    off, nval = im[:, 3], im[:, 4]
    rows = np.flatnonzero(nval > 0)
    w2, off, nval = w2[rows], off[rows], nval[rows]
    u_lo = off // w2
    h = (off + nval - 1) // w2 + 1 - u_lo          # i1 entries of each row
    if mode == 1:
        run = B_RUN
        while run > 1 and int((-(-h // run)).sum()) < min_tiles:
            run -= 1
        nt = -(-h // run)
        r = np.repeat(np.arange(len(rows)), nt)
        t = np.arange(len(r)) - np.repeat(np.cumsum(nt) - nt, nt)
        u0 = u_lo[r] + t * run
        nu = np.minimum(run, u_lo[r] + h[r] - u0)
        tiles = np.stack([rows[r], u0, np.zeros_like(u0), nu, w2[r]], axis=1)
    else:
        nt2 = -(-w2 // TILE_COLS)
        tv = -(-w2 // nt2)
        nt1 = -(-h // np.maximum(TILE_QUERIES // tv, 1))
        tu = -(-h // nt1)
        per = nt1 * nt2
        r = np.repeat(np.arange(len(rows)), per)
        t = np.arange(len(r)) - np.repeat(np.cumsum(per) - per, per)
        a, b = t // nt2[r], t % nt2[r]
        u0 = u_lo[r] + a * tu[r]
        v0 = b * tv[r]
        nu = np.minimum(tu[r], u_lo[r] + h[r] - u0)
        nv = np.minimum(tv[r], w2[r] - v0)
        tiles = np.stack([rows[r], u0, v0, nu, nv], axis=1)
    return tiles.astype(np.int32).reshape(-1, 5)


def b_min_tiles(device) -> int:
    """The least number of B tiles a launch on `device` should have: four a
    multiprocessor of a CUDA device (two waves of the two B blocks an SM
    holds), 0 elsewhere."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0
    return 4 * torch.cuda.get_device_properties(device).multi_processor_count


def sweep_kernel(kern: str, mode: int) -> str:
    """The launch count's name of K2 of family `kern` in `mode`."""
    return f"{K2[kern]}.{'pool' if mode == 0 else 'B'}"


def b_window(n2f: int, inv_scale: float, kern: str = "D5512") -> int:
    """The widest window (samples per axis) that the query floors of one
    n2f-point lattice axis can span: they differ by at most
    floor((n2f - 1) |inv_scale|) + 2, rounding included, and the family's
    taps add their width."""
    return int(math.floor((n2f - 1) * abs(inv_scale))) + 2 + _interp.KERNEL_FAMILIES[kern][2]


def b_smem_bytes(n2f: int, wmax: int, kern: str = "D5512") -> int:
    """Shared memory of a B-mode block of the family for n2f and a window
    of at most wmax x wmax samples, as the kernel's library sizes it
    (csrc/interp_d5512.cu, b_smem_bytes)."""
    fn = _build.library("interp_d5512").interp_b_smem_bytes
    fn.argtypes, fn.restype = (_i, _i, _i), ctypes.c_size_t
    return int(fn(_interp.KERNEL_FAMILIES[kern][2], n2f, wmax))


def _sweep_args(ks, imeta, dmeta, tiles, mode, n_pad, n2f):
    if mode not in (0, 1):
        raise ValueError(f"mode must be 0 (pool) or 1 (B), got {mode}")
    if mode == 1 and (n2f <= 0 or n_pad <= 0):
        raise ValueError(f"B mode needs n2f > 0 and n_pad > 0, got {n2f}, {n_pad}")
    dw = 5 if mode == 0 else 4
    ks = ks.reshape(-1)
    imeta = imeta.reshape(-1, 5)
    dmeta = dmeta.reshape(-1, dw)
    tiles = tiles.reshape(-1, 5)
    if not (ks.shape[0] == imeta.shape[0] == dmeta.shape[0]):
        raise ValueError("ks, imeta and the scatter metadata need one row each "
                         f"({ks.shape[0]}, {imeta.shape[0]}, {dmeta.shape[0]})")
    return ks, imeta, dmeta, tiles


def check_output_lattice(xt, yt, imeta, n2f: int) -> None:
    """
    Raise ValueError unless every live B row (nval > 0) pairs with an exact
    output lattice: w2 == n2f**2, and from its i2_start on, the tables hold
    xt[i2_start + p] == xt[i2_start] + p % n2f and yt[i2_start + p] ==
    yt[i2_start] + p // n2f for p < n2f**2.  Host numpy, on the plan.
    """
    m = n2f * n2f
    xt, yt = np.asarray(xt), np.asarray(yt)
    im = np.asarray(imeta, np.int64).reshape(-1, 5)
    live = im[im[:, 4] > 0]
    starts = np.unique(live[:, 1])
    ok = bool(np.all(live[:, 2] == m) and np.all(starts >= 0)
              and np.all(starts + m <= len(xt)))
    if ok:
        p = np.arange(m)
        idx = starts[:, None] + p
        ok = (np.array_equal(xt[idx], xt[starts][:, None] + p % n2f)
              and np.array_equal(yt[idx], yt[starts][:, None] + p // n2f))
    if not ok:
        raise ValueError(_LATTICE_ERROR.format(n2f=n2f))


def _l2_counter(device: torch.device) -> torch.Tensor:
    c = _l2_counters.get(device)
    if c is None:
        c = _l2_counters[device] = torch.zeros(1, dtype=torch.int64, device=device)
    return c


_l2_counters: dict[torch.device, torch.Tensor] = {}


def l2_tiles(device) -> int:
    """Pool tiles that K2 interpolated from L2 (in part: from an i1 whose
    window alone outgrew a slot of POOL_SLOT_DOUBLES) on `device` since the
    last :func:`reset_l2_tiles`."""
    return int(_l2_counter(torch.device(device)).item())


def reset_l2_tiles() -> None:
    for c in _l2_counters.values():
        c.zero_()


def sweep_scatter(dst, combined, xt, yt, ks, imeta, dmeta, tiles, inv_scale,
                  off_grid, mode: int, n_pad: int = 0, n2f: int = 0,
                  kern: str = "D5512") -> torch.Tensor:
    """
    K2 of the family `kern`: add the interpolated overlap value of every
    query into `dst` (in place; returned).

    dst (P,) f64; combined (K, ny, nx) f64; xt, yt (L,) f64; ks (..., )
    int32 image per row; imeta (..., 5) int32 rows [i1_start, i2_start, w2,
    off, nval]; dmeta (..., 5) pool rows [dst_base0, w2, stride, off, nval]
    in mode 0, or (..., 4) B rows [dst_base, col0, off, nval] in mode 1;
    tiles (T, 5) int32 from :func:`sweep_tiles`.  Query j < nval of a row
    sits at f = off + j.  Mode 1 needs the output lattice's n2f and n_pad,
    and takes output pixel p of a row at (xt[i2_start] + p % n2f,
    yt[i2_start] + p // n2f): its tiles come from :func:`sweep_tiles`, which
    raises unless the tables hold that lattice.  The kernel adds with f64
    atomics, in no fixed order: where no destination receives two queries
    (as on the coadd's path) its result does not depend on it.
    """
    _interp.check_kern(kern)
    dev = dst.device
    ks, imeta, dmeta, tiles = _sweep_args(ks, imeta, dmeta, tiles, mode, n_pad, n2f)
    _check(dst, "dst", torch.float64, dev, 1)
    _check(combined, "combined", torch.float64, dev, 3)
    _check(xt, "xt", torch.float64, dev, 1)
    _check(yt, "yt", torch.float64, dev, 1)
    for name, t in (("ks", ks), ("imeta", imeta), ("dmeta", dmeta), ("tiles", tiles)):
        _check(t, name, torch.int32, dev, t.dim())
    if yt.shape != xt.shape:
        raise ValueError("xt and yt must have one length")
    if max(dst.shape[0], xt.shape[0], combined.numel()) >= 2 ** 31:
        raise ValueError("K2 indexes with int32: dst, the tables and the stack "
                         "must hold fewer than 2**31 entries")
    wmax = 0
    if mode == 1:
        wmax = b_window(n2f, inv_scale, kern)
        smem = b_smem_bytes(n2f, wmax, kern)
        if smem > _SMEM_LIMIT:
            raise ValueError(f"B mode: n2f {n2f} at {inv_scale} samples per output "
                             f"pixel needs {smem} bytes of shared memory a block")
    if tiles.shape[0] == 0:
        return dst
    K, ny, nx = combined.shape
    _launch(K2[kern], sweep_kernel(kern, mode), dev, dst.data_ptr(), dst.shape[0],
            combined.data_ptr(), K, ny, nx, xt.data_ptr(), yt.data_ptr(),
            xt.shape[0], ks.data_ptr(), imeta.data_ptr(), dmeta.data_ptr(),
            tiles.data_ptr(), tiles.shape[0], float(inv_scale), float(off_grid),
            mode, int(n_pad), int(n2f), wmax, _l2_counter(dev).data_ptr())
    return dst


def sweep_scatter_plain(dst, combined, xt, yt, ks, imeta, dmeta, tiles,
                        inv_scale, off_grid, mode: int, n_pad: int = 0,
                        n2f: int = 0, kern: str = "D5512") -> torch.Tensor:
    """Plain version of K2 (same function and arguments, any device): the
    queries of every tile, interpolated and added with ``index_add_``;
    updates dst in place."""
    ks, imeta, dmeta, tiles = _sweep_args(ks, imeta, dmeta, tiles, mode, n_pad, n2f)
    dev = dst.device
    ks, imeta, dmeta, tiles = ks.long(), imeta.long(), dmeta.long(), tiles.long()
    K = combined.shape[0]
    L = xt.shape[0]
    m = n2f * n2f
    nq = tiles[:, 3] * tiles[:, 4]
    width = int(nq.max()) if len(nq) else 0
    q = torch.arange(width, device=dev)[None, :]
    step = max(1, (1 << 16) // max(width, 1))
    for t0 in range(0, tiles.shape[0], step):
        tl = tiles[t0:t0 + step]
        r = tl[:, 0]
        im, dm = imeta[r], dmeta[r]
        nv = tl[:, 4:5].clamp(min=1)
        w2 = im[:, 2:3].clamp(min=1) if mode == 0 else torch.full_like(nv, m)
        f = (tl[:, 1:2] + q // nv) * w2 + tl[:, 2:3] + q % nv
        j = f - im[:, 3:4]
        ok = (q < nq[t0:t0 + step, None]) & (j >= 0) & (j < im[:, 4:5])
        if mode == 0:
            g = dm[:, 3:4] + j
            w2d = dm[:, 1:2].clamp(min=1)
            d = dm[:, 0:1] + (g // w2d) * dm[:, 2:3] + g % w2d
            ok &= j < dm[:, 4:5]
        else:
            g = dm[:, 2:3] + j
            d = dm[:, 0:1] + (g % m) * n_pad + dm[:, 1:2] + g // m
            ok &= j < dm[:, 3:4]
        i1, v = im[:, 0:1] + f // w2, f % w2
        i2 = im[:, 1:2] + v
        k = ks[r][:, None].expand_as(f)
        ok = (ok & (d >= 0) & (d < dst.shape[0]) & (k >= 0) & (k < K)
              & (i1 >= 0) & (i1 < L) & (i2 >= 0) & (i2 < L))
        if mode == 1:
            # B: the row's whole lattice lies inside the tables
            ok &= (im[:, 1:2] >= 0) & (im[:, 1:2] + m <= L)
        i1, i2, v, k, d = (t[ok] for t in (i1, i2, v, k, d))
        if mode == 0:
            x2, y2 = xt[i2], yt[i2]
        else:
            # output pixel v of the lattice at i2_start, formed as the kernel does
            i2s = i2 - v
            x2, y2 = xt[i2s] + v % n2f, yt[i2s] + v // n2f
        qx = (xt[i1] - x2) * inv_scale + off_grid
        qy = (yt[i1] - y2) * inv_scale + off_grid
        dst.index_add_(0, d, _interp.interp2d_stack(combined, qx, qy, k, kern))
    return dst
