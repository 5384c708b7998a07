"""
The port's hand-written Hopper kernels for the destriping bilinear pair,
and their ctypes wrappers.

K3 ``bilinear_gather`` replaces the JAX package's device gathers
``bilinear_gather_device`` and ``bilinear_gather_weighted_device``
(``pyimcom_tpu/ops/bilinear.py``); K4 ``bilinear_scatter_adjoint`` replaces
``bilinear_scatter_adjoint_device`` and, with a gain, the image cotangent
that ``jax.value_and_grad`` takes through the destripe cost's weighted
gather.  Both live in ``csrc/bilinear.cu`` (its header says what bounds them
on the card and what the design does about it), built by ``nvcc`` at first
use (``_build.py``).  A wrapper takes contiguous f64 CUDA tensors on one
device only, the positions xf, yf f64 or both f32, and raises on anything
else; it launches on the current stream, allocates its output with torch,
checks the launch and counts it in ``launches``, the float32-position forms
under their own names (``bilinear_gather.f32``,
``bilinear_scatter_adjoint.f32``).  Those forms widen each position to
float64 as they read it, so they compute what the f64 forms compute on the
widened positions.  The plain versions are in ``ops/bilinear.py``.

K4 on a 2-D query grid (a destripe pair passes the target's pixel grid)
is owner-writes over a per-pair plan: one block a 32 x 32 tile of the
output, which stages the queries the plan names for it and writes each of
its pixels once, with no f64 atomic and its sums in a fixed order (two
launches give the same bits).  :func:`build_adjoint_plan` builds the plan
on the card with the plan kernel of the same file (``bilinear_adjoint_plan``:
one C entry a plan, one pass over the positions and two over the tiles,
counted under that name) and on a CPU tensor with its plain version
(:func:`build_adjoint_plan_plain`); a caller that launches K4 many times on
one map (the destripe cost) builds it once and passes it; a call without
one builds it.  A 1-D stream (or a grid wider than
``PLAN_MAX_COLS`` columns) has no plan, and a plan whose tiles' queries
overflowed the plan kernel's ring (a map shrunk ~5x or more) covers only
part of them (:func:`plan_route`): both take the earlier tiled body, which
takes any positions and counts its tiles in :func:`off_plan_tiles`;
:func:`predict_off_plan_tiles` computes the same count in plain torch.
``adjoint_routes`` counts K4's launches by route.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from .. import _build
from .interp_cuda import _check

# launches of each kernel since the last reset_launch_counts(); incremented
# by the wrappers where they launch, and nowhere else; a form on float32
# positions counts under its kernel's name + ".f32"
launches = {"bilinear_gather": 0, "bilinear_scatter_adjoint": 0,
            "bilinear_gather.f32": 0, "bilinear_scatter_adjoint.f32": 0,
            "bilinear_adjoint_plan": 0, "bilinear_adjoint_plan.f32": 0}
# the position dtypes a kernel takes, and the suffix of their form's C entry
POSITION_FORMS = {torch.float64: "", torch.float32: "_f32"}

# K4's launches by route: over a plan, or the tiled body off the plan
adjoint_routes = {"planned": 0, "stream": 0}

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_GATHER_ARGS = (_p, _p, _i, _i, _p, _p, _ll, _p, _i, _p)
_PLANNED_ARGS = (_p, _p, _i, _i, _p, _p, _i, _i, _p, _p, _p, _p, _i, _p)
_STREAM_ARGS = (_p, _p, _i, _i, _p, _p, _i, _i, _p, _p, _p)
_PLAN_ARGS = (_p, _p, _i, _i, _i, _i, _p, _p, _p, _p, _p, _p)
_SIGNATURES = {"bilinear_gather": _GATHER_ARGS, "bilinear_gather_f32": _GATHER_ARGS,
               "bilinear_scatter_adjoint": _PLANNED_ARGS,
               "bilinear_scatter_adjoint_f32": _PLANNED_ARGS,
               "bilinear_scatter_adjoint_stream": _STREAM_ARGS,
               "bilinear_scatter_adjoint_stream_f32": _STREAM_ARGS,
               "bilinear_adjoint_plan": _PLAN_ARGS, "bilinear_adjoint_plan_f32": _PLAN_ARGS}
# K4's plan, as csrc/bilinear.cu reads it: output pixels a side of a tile,
# query rows a band, and the widest query grid (columns are 16-bit); the
# window queries the kernel stages at a time (kChunk)
PLAN_TILE, PLAN_BAND, PLAN_MAX_COLS, PLAN_CHUNK = 32, 4, 65535, 1280
# the most query rows a tile's queries may span (the plan kernel keeps a
# tile's columns a row in a ring of this many rows, kRing), and the tiles a
# block of its counts pass takes (kPlanScan)
PLAN_RING_ROWS, PLAN_SCAN_TILES = 256, 2048
# query rows of positions one step of build_adjoint_plan reads
PLAN_BUILD_ROWS = 256
# the off-plan body's tiling: (rows, columns) of queries a tile of a grid
# and of one row
ADJOINT_TILE, ADJOINT_ROW_TILE = (32, 32), (1, 1024)


def reset_launch_counts() -> None:
    for counts in (launches, adjoint_routes):
        for k in counts:
            counts[k] = 0


def _launch(name: str, pos_dtype, device: torch.device, *args, route: str = "") -> None:
    """Launch kernel `name` (its C entry `name` + `route`) in its form for
    positions of `pos_dtype`."""
    suffix = POSITION_FORMS[pos_dtype]
    entry = name + route + suffix
    fn = getattr(_build.library("bilinear"), entry)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[entry]
        fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {entry} failed to launch: cudaError {err}")
    launches[name + suffix.replace("_", ".")] += 1


def _check_pair(shape, xf, yf, g_eff, dev):
    """Check the positions (f64, or both f32) and the gain; returns (ny, nx)."""
    pos = xf.dtype if xf.dtype in POSITION_FORMS else torch.float64
    _check(xf, "xf", pos, dev, xf.dim())
    _check(yf, "yf", pos, dev, yf.dim())
    if yf.shape != xf.shape:
        raise ValueError(f"xf and yf must have one shape, got {tuple(xf.shape)} and "
                         f"{tuple(yf.shape)}")
    if g_eff is not None:
        _check(g_eff, "g_eff", torch.float64, dev, 2)
        if tuple(g_eff.shape) != tuple(shape):
            raise ValueError(f"g_eff must have the image's shape {tuple(shape)}, got "
                             f"{tuple(g_eff.shape)}")
    ny, nx = shape
    if ny * nx >= 2 ** 31:
        raise ValueError("K3 and K4 index the image with int32: it must hold fewer than "
                         "2**31 pixels")
    return ny, nx


def _ptr(t):
    return None if t is None else t.data_ptr()


def query_grid(xf: torch.Tensor) -> tuple[int, int]:
    """K4's (qny, qnx) query grid of positions `xf`: its own shape if 2-D,
    its last axis by the rest if more, one row if 1-D."""
    if xf.dim() >= 2:
        return xf.numel() // max(xf.shape[-1], 1), xf.shape[-1]
    return 1, xf.numel()


def planned_route(qny: int, qnx: int) -> bool:
    """Whether a (qny, qnx) query grid has a K4 plan: a grid of more than
    one row and at most PLAN_MAX_COLS columns (K4 runs over the plan where
    :func:`plan_route` says so)."""
    return qny > 1 and qnx <= PLAN_MAX_COLS


@dataclass(frozen=True)
class AdjointPlan:
    """
    K4's plan of one set of positions: for each 32 x 32 tile t of the
    (ny, nx) output, row-major, the queries whose floor tap lies in its
    33 x 33 window of tap cells (the tile, one row above and one column
    left), as ``rows[t]`` = its first and last query row and, for each band
    k of PLAN_BAND query rows from the first, ``spans[ptr[t] + k]`` = lo |
    hi << 16, the band's columns (lo > hi: none); a tile without a query has
    no band, rows (0, -1).  `meta` (4,) int64 on the plan's device holds
    the counts: `pairs` (the (tile, query) incidences), `bands`, `window`
    (the queries the kernel stages: each band's rows times its span) and
    `over`, the tiles whose rows span PLAN_RING_ROWS or more: such a tile
    keeps its rows but has no band, so a plan with one (overflowed) misses
    its queries and K4 takes the off-plan body instead (:func:`plan_route`);
    ``r`` = window / pairs.  The plan kernel writes the counts on the card
    without waiting, so a plan built there reads them back, and cuts its
    `spans` (sized for the most bands the grid allows) to its bands, at the
    first read of a count (:meth:`check`).
    """

    rows: torch.Tensor
    ptr: torch.Tensor
    spans: torch.Tensor
    shape: tuple
    grid: tuple
    meta: torch.Tensor

    def check(self) -> "AdjointPlan":
        """Read the counts back (once) and cut `spans` to the plan's bands;
        returns the plan."""
        if "_counts" not in self.__dict__:
            self._settle(self.meta.tolist())
        return self

    def _settle(self, meta) -> None:
        """Keep the counts `meta` (pairs, bands, window, over) and cut
        `spans` to the bands (a copy: the kernel's buffer is left whole)."""
        counts = tuple(int(v) for v in meta)
        if self.spans.numel() > counts[1]:
            object.__setattr__(self, "spans", self.spans[:counts[1]].clone())
        self.__dict__["_counts"] = counts

    @property
    def pairs(self) -> int:
        return self.check()._counts[0]

    @property
    def bands(self) -> int:
        return self.check()._counts[1]

    @property
    def window(self) -> int:
        return self.check()._counts[2]

    @property
    def over(self) -> int:
        return self.check()._counts[3]

    @property
    def r(self) -> float:
        return self.window / self.pairs if self.pairs else 1.0

    @property
    def nbytes(self) -> int:
        """Bytes of the plan's words: rows, ptr and its bands' spans."""
        return 4 * (self.rows.numel() + self.ptr.numel() + self.bands)

    def tile_windows(self) -> torch.Tensor:
        """The queries the kernel stages for each tile (int64, T)."""
        T = self.ptr.numel() - 1
        nb = (self.ptr[1:] - self.ptr[:-1]).long()
        tile = torch.repeat_interleave(torch.arange(T, device=nb.device), nb)
        band = torch.arange(tile.numel(), device=nb.device) - self.ptr[:-1].long()[tile]
        first = self.rows[:, 0].long()[tile] + PLAN_BAND * band
        rows = torch.minimum(first + PLAN_BAND - 1, self.rows[:, 1].long()[tile]) - first + 1
        span = self.spans.long() & 0xFFFFFFFF
        width = torch.clamp((span >> 16) - (span & 0xFFFF) + 1, min=0)
        return torch.zeros(T, dtype=torch.int64, device=nb.device).index_add_(0, tile,
                                                                             rows * width)


def _plan_incidences(x, y, r0: int, shape, tiles_x: int, drop: int):
    """The (tile, query) incidences of the queries x, y (query rows r0.. of
    the grid, 2-D): tiles (4, n) -- the tile of the tap's pixel, then the
    tile below, right and below-right where the tap's other pixels fall in
    another tile, else `drop`, as for a query out of bounds -- and the
    queries' rows and columns (n,)."""
    from .bilinear import in_bounds

    ny, nx = shape
    inb = in_bounds(x, y, shape)
    ix = torch.where(inb, torch.floor(x.double()), 0.0).long()
    iy = torch.where(inb, torch.floor(y.double()), 0.0).long()
    ty0, tx0 = iy // PLAN_TILE, ix // PLAN_TILE
    ty1, tx1 = (iy + 1) // PLAN_TILE, (ix + 1) // PLAN_TILE
    down, right = ty1 != ty0, tx1 != tx0
    tiles = torch.stack([torch.where(keep, ty * tiles_x + tx, drop) for ty, tx, keep in (
        (ty0, tx0, inb), (ty1, tx0, inb & down), (ty0, tx1, inb & right),
        (ty1, tx1, inb & down & right))]).reshape(4, -1)
    qr = torch.arange(r0, r0 + x.shape[0], device=x.device)[:, None].expand(x.shape)
    qc = torch.arange(x.shape[1], device=x.device)[None, :].expand(x.shape)
    return tiles, qr.reshape(-1), qc.reshape(-1)


def _runs(key, qr, n_keys):
    """The runs of equal `key` within each query row of flat incidences
    (key (m,) in [0, n_keys], query rows qr (m,) nondecreasing): each run's
    key and its first and last index.  Along a row a key holds for a run of
    columns (a tile's stretch of a near-affine map), so the reductions take
    one entry a run, not one a query."""
    keys, counts = torch.unique_consecutive(key + (n_keys + 1) * qr, return_counts=True)
    last = torch.cumsum(counts, 0) - 1
    return keys % (n_keys + 1), last - counts + 1, last


def _plan_grid(xf: torch.Tensor, shape):
    """(ny, nx), (qny, qnx) and the tiles (T, tiles_x) of K4's plan of
    positions `xf` on a `shape` output; raises off the planned route."""
    ny, nx = (int(v) for v in shape)
    qny, qnx = query_grid(xf)
    if not planned_route(qny, qnx):
        raise ValueError(f"a {qny} x {qnx} query grid has no K4 plan: it needs more than one "
                         f"row and at most {PLAN_MAX_COLS} columns")
    tiles_x = -(-nx // PLAN_TILE)
    return (ny, nx), (qny, qnx), -(-ny // PLAN_TILE) * tiles_x, tiles_x


def build_adjoint_plan_plain(xf: torch.Tensor, yf: torch.Tensor, shape) -> AdjointPlan:
    """The plain version of :func:`build_adjoint_plan`: the plan
    (:class:`AdjointPlan`) of the positions xf, yf (f64 or f32, a 2-D query
    grid: :func:`planned_route`) on a (ny, nx) = `shape` output, in plain
    torch on their device: two passes over the positions, PLAN_BUILD_ROWS
    query rows a step (each tile's first and last row, then each band's
    columns), each reducing one entry a run of a row's queries with one key
    (:func:`_runs`).  A tile whose rows span PLAN_RING_ROWS or more gets no
    band and counts in `over`, as in the kernel's plan."""
    (ny, nx), (qny, qnx), T, tiles_x = _plan_grid(xf, shape)
    x, y = xf.reshape(qny, qnx), yf.reshape(qny, qnx)
    dev = x.device
    big = torch.iinfo(torch.int64).max
    steps = range(0, qny, PLAN_BUILD_ROWS)

    def step(r0):
        return _plan_incidences(x[r0:r0 + PLAN_BUILD_ROWS], y[r0:r0 + PLAN_BUILD_ROWS], r0,
                                (ny, nx), tiles_x, T)

    # each tile's first and last query row
    row_lo = torch.full((T + 1,), big, dtype=torch.int64, device=dev)
    row_hi = torch.full((T + 1,), -1, dtype=torch.int64, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    for r0 in steps:
        t, qr, _qc = step(r0)
        for k in range(4):
            key, first, _last = _runs(t[k], qr, T)
            row_lo.scatter_reduce_(0, key, qr[first], "amin")
            row_hi.scatter_reduce_(0, key, qr[first], "amax")
        pairs += (t < T).sum()
    row_lo, row_hi = row_lo[:T], row_hi[:T]
    live = row_hi >= 0
    # a tile whose rows span the kernel's ring keeps its rows, but no band
    over = live & (row_hi - row_lo >= PLAN_RING_ROWS)
    nb = torch.where(live & ~over, (row_hi - row_lo) // PLAN_BAND + 1, 0)
    nbt = int(nb.max()) if T else 0
    # each band's columns
    col_lo = torch.full((T * nbt + 1,), big, dtype=torch.int64, device=dev)
    col_hi = torch.full((T * nbt + 1,), -1, dtype=torch.int64, device=dev)
    for r0 in steps if nbt else ():
        t, qr, qc = step(r0)
        tt = torch.where(t < T, t, 0)
        keep = (t < T) & ~over[tt]
        band_key = torch.where(keep, tt * nbt + (qr - row_lo[tt]) // PLAN_BAND, T * nbt)
        for k in range(4):
            # a run lies in one row, its columns increasing
            key, first, last = _runs(band_key[k], qr, T * nbt)
            col_lo.scatter_reduce_(0, key, qc[first], "amin")
            col_hi.scatter_reduce_(0, key, qc[last], "amax")
    band = torch.arange(nbt, device=dev)
    mask = band[None, :] < nb[:, None]
    lo, hi = col_lo[:T * nbt].reshape(T, nbt)[mask], col_hi[:T * nbt].reshape(T, nbt)[mask]
    empty = hi < 0
    lo, hi = torch.where(empty, 0xFFFF, lo), torch.where(empty, 0, hi)
    packed = lo | (hi << 16)
    spans = torch.where(packed >= 2 ** 31, packed - 2 ** 32, packed).to(torch.int32)
    tile = torch.arange(T, device=dev)[:, None].expand(T, nbt)[mask]
    first = row_lo[tile] + PLAN_BAND * band[None, :].expand(T, nbt)[mask]
    band_rows = torch.minimum(first + PLAN_BAND - 1, row_hi[tile]) - first + 1
    window = int((band_rows * torch.where(empty, 0, hi - lo + 1)).sum())
    rows = torch.stack([torch.where(live, row_lo, 0), torch.where(live, row_hi, -1)], 1)
    ptr = torch.cat([nb.new_zeros(1), torch.cumsum(nb, 0)])
    meta = torch.tensor([int(pairs), spans.numel(), window, int(over.sum())],
                        dtype=torch.int64, device=dev)
    return AdjointPlan(rows=rows.to(torch.int32).contiguous(), ptr=ptr.to(torch.int32),
                       spans=spans.contiguous(), shape=(ny, nx), grid=(qny, qnx), meta=meta)


def build_adjoint_plan(xf: torch.Tensor, yf: torch.Tensor, shape) -> AdjointPlan:
    """K4's plan (:class:`AdjointPlan`) of the positions xf, yf (f64, or
    both f32, contiguous; a 2-D query grid: :func:`planned_route`) on a
    (ny, nx) = `shape` output.  On a CUDA tensor the plan kernel's one C
    entry (``bilinear_adjoint_plan``: a pass over the positions and two over
    the tiles), enqueued without waiting: no host synchronisation, the
    counts read back at their first use (:meth:`AdjointPlan.check`); on a CPU
    tensor its plain version, :func:`build_adjoint_plan_plain`, which gives
    the same plan."""
    if xf.device.type == "cpu":
        return build_adjoint_plan_plain(xf, yf, shape)
    (ny, nx), (qny, qnx), T, _tiles_x = _plan_grid(xf, shape)
    dev = xf.device
    _check_pair((ny, nx), xf, yf, None, dev)
    if T * PLAN_RING_ROWS >= 2 ** 31:
        raise ValueError(f"K4's plan of {T} tiles outgrows the plan kernel's int32 rings")
    i32 = dict(dtype=torch.int32, device=dev)
    rows, ptr = torch.empty((T, 2), **i32), torch.empty(T + 1, **i32)
    spans = torch.empty(T * -(-min(qny, PLAN_RING_ROWS) // PLAN_BAND), **i32)
    meta = torch.empty(4, dtype=torch.int64, device=dev)
    scratch = torch.empty(2 * (T * (PLAN_RING_ROWS + 1) + T // PLAN_SCAN_TILES + 1), **i32)
    _launch("bilinear_adjoint_plan", xf.dtype, dev, xf.data_ptr(), yf.data_ptr(), qny, qnx, ny,
            nx, scratch.data_ptr(), rows.data_ptr(), ptr.data_ptr(), spans.data_ptr(),
            meta.data_ptr())
    return AdjointPlan(rows=rows, ptr=ptr, spans=spans, shape=(ny, nx), grid=(qny, qnx),
                       meta=meta)


def check_plans(plans) -> None:
    """:meth:`AdjointPlan.check` of every plan in `plans` (None skipped)
    whose counts were not read yet, with one read-back for all of them."""
    todo = [p for p in plans if p is not None and "_counts" not in p.__dict__]
    if todo:
        for p, meta in zip(todo, torch.stack([p.meta.to(todo[0].meta.device)
                                              for p in todo]).tolist()):
            p._settle(meta)


def plan_route(plan: AdjointPlan) -> str:
    """K4's route over `plan` (its counts read back if they were not):
    "planned" where the plan covers every query, "stream" (the off-plan
    body) where a tile's queries overflowed the plan kernel's ring."""
    return "stream" if plan.over else "planned"


def _check_plan(plan, shape, grid, dev) -> None:
    if not isinstance(plan, AdjointPlan):
        raise TypeError(f"plan must be an AdjointPlan, got {type(plan).__name__}")
    if tuple(plan.shape) != tuple(shape) or tuple(plan.grid) != tuple(grid):
        raise ValueError(f"the plan is for a {plan.grid} query grid on a {plan.shape} output, "
                         f"not {tuple(grid)} on {tuple(shape)}")
    for name in ("rows", "ptr", "spans"):
        _check(getattr(plan, name), f"plan.{name}", torch.int32, dev, getattr(plan, name).dim())


def predict_off_plan_tiles(xf: torch.Tensor, yf: torch.Tensor, shape,
                           plan: AdjointPlan | None = None) -> int:
    """The K4 tiles these positions give the off-plan body, in plain torch
    (any device): none on a planned grid whose plan (`plan`, the caller's
    plan of these positions, else :func:`build_adjoint_plan_plain`'s) takes
    the planned route (:func:`plan_route`); else each of its tiles (1 x 1024
    queries of one row, 32 x 32 of a grid) that holds a query in bounds."""
    from .bilinear import in_bounds

    qny, qnx = query_grid(xf)
    if xf.numel() == 0:
        return 0
    if planned_route(qny, qnx):
        if plan is None:
            plan = build_adjoint_plan_plain(xf, yf, shape)
        if plan_route(plan) == "planned":
            return 0
    th, tw = ADJOINT_ROW_TILE if qny == 1 else ADJOINT_TILE
    ty, tx = -(-qny // th), -(-qnx // tw)
    full = torch.zeros((ty * th, tx * tw), dtype=torch.bool, device=xf.device)
    full[:qny, :qnx] = in_bounds(xf, yf, shape).reshape(qny, qnx)
    return int(full.reshape(ty, th, tx, tw).any(3).any(1).sum())


def _off_plan_counter(device: torch.device) -> torch.Tensor:
    c = _off_plan_counters.get(device)
    if c is None:
        c = _off_plan_counters[device] = torch.zeros(1, dtype=torch.int64, device=device)
    return c


_off_plan_counters: dict[torch.device, torch.Tensor] = {}


def off_plan_tiles(device) -> int:
    """K4 tiles that the off-plan body ran with a query in bounds on
    `device` since the last :func:`reset_off_plan_tiles`."""
    return int(_off_plan_counter(torch.device(device)).item())


def reset_off_plan_tiles() -> None:
    for c in _off_plan_counters.values():
        c.zero_()


def bilinear_gather(image: torch.Tensor, xf: torch.Tensor, yf: torch.Tensor,
                    g_eff: torch.Tensor | None = None, *,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """
    K3: image (ny, nx) f64, xf, yf (any shape, one shape; f64, or both
    f32) CUDA -> the f64 bilinear values at (xf, yf), 0 out of bounds or at
    a NaN position; with
    `g_eff` (ny, nx), gain-weighted and normalised.  With `out` (xf's shape)
    the values are added into it in place, and it is returned.
    """
    dev = image.device
    _check(image, "image", torch.float64, dev, 2)
    ny, nx = _check_pair(image.shape, xf, yf, g_eff, dev)
    if out is None:
        result = torch.empty(xf.shape, dtype=torch.float64, device=dev)
    else:
        _check(out, "out", torch.float64, dev, out.dim())
        if out.shape != xf.shape:
            raise ValueError(f"out must have xf's shape {tuple(xf.shape)}, got "
                             f"{tuple(out.shape)}")
        result = out
    if xf.numel() == 0:
        return result
    _launch("bilinear_gather", xf.dtype, dev, image.data_ptr(), _ptr(g_eff), ny, nx,
            xf.data_ptr(), yf.data_ptr(), xf.numel(), result.data_ptr(), int(out is not None))
    return result


def bilinear_scatter_adjoint(values: torch.Tensor, xf: torch.Tensor, yf: torch.Tensor,
                             shape, g_eff: torch.Tensor | None = None, *,
                             out: torch.Tensor | None = None,
                             plan: AdjointPlan | None = None) -> torch.Tensor:
    """
    K4: the exact adjoint of K3 with respect to the image: values f64 and
    xf, yf (f64, or both f32), one shape, CUDA -> (ny, nx) = `shape` f64,
    each in-bounds value added into its four taps with K3's weights (and
    gain).  On a planned grid (:func:`planned_route`) over `plan`
    (:func:`build_adjoint_plan` of these positions and `shape`; built and
    read back here if not given) where it covers every query
    (:func:`plan_route`), each output pixel written once, its sum in a fixed
    order; else (a 1-D stream, a grid too wide for a plan, a plan that
    overflowed) by the off-plan body, with atomics, in no fixed order.  With
    `out` ((ny, nx) f64) the contributions are added into it in place, and
    it is returned.
    """
    dev = values.device
    _check(values, "values", torch.float64, dev, values.dim())
    ny, nx = _check_pair(tuple(shape), xf, yf, g_eff, dev)
    if values.shape != xf.shape:
        raise ValueError(f"values must have xf's shape {tuple(xf.shape)}, got "
                         f"{tuple(values.shape)}")
    if out is not None:
        _check(out, "out", torch.float64, dev, 2)
        if tuple(out.shape) != (ny, nx):
            raise ValueError(f"out must have the image's shape {(ny, nx)}, got "
                             f"{tuple(out.shape)}")
    qny, qnx = query_grid(xf)
    if qny >= 2 ** 31 or qnx >= 2 ** 31:
        raise ValueError("K4 indexes the query grid's rows and columns with int32")
    planned = planned_route(qny, qnx)
    if plan is not None:
        if not planned:
            raise ValueError(f"a {qny} x {qnx} query grid takes no plan")
        _check_plan(plan, (ny, nx), (qny, qnx), dev)
    if xf.numel() == 0:
        return out if out is not None else torch.zeros((ny, nx), dtype=torch.float64,
                                                       device=dev)
    if planned and plan is None:
        # built for this call alone (plan_route reads its counts back)
        plan = build_adjoint_plan(xf, yf, (ny, nx))
    if planned and plan_route(plan) == "planned":
        result = out if out is not None else torch.empty((ny, nx), dtype=torch.float64,
                                                         device=dev)
        _launch("bilinear_scatter_adjoint", xf.dtype, dev, values.data_ptr(), _ptr(g_eff), ny,
                nx, xf.data_ptr(), yf.data_ptr(), qny, qnx, plan.rows.data_ptr(),
                plan.ptr.data_ptr(), plan.spans.data_ptr(), result.data_ptr(),
                int(out is not None))
        adjoint_routes["planned"] += 1
        return result
    result = out if out is not None else torch.zeros((ny, nx), dtype=torch.float64, device=dev)
    _launch("bilinear_scatter_adjoint", xf.dtype, dev, values.data_ptr(), _ptr(g_eff), ny, nx,
            xf.data_ptr(), yf.data_ptr(), qny, qnx, result.data_ptr(),
            _off_plan_counter(dev).data_ptr(), route="_stream")
    adjoint_routes["stream"] += 1
    return result
