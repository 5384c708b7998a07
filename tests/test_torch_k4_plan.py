"""K4's plan and its planned traversal against the plain adjoint and the
JAX package's, on the CPU.

The plan (pyimcom_tpu_torch/ops/bilinear_cuda.build_adjoint_plan) names, for
each 32 x 32 tile of the output, the queries whose floor tap lies in the
tile's 33 x 33 window of tap cells; it is held to a brute-force loop over
the tiles (complete: every such query is staged once; tight: each tile's
rows and each band's columns are those of its queries).  The kernel cannot
run here, so tests/k4_plan_torch.py emulates its traversal (tiles, band
groups, chunks, the window filter, the order of each pixel's sum), held to
bilinear_scatter_adjoint_plain and to the JAX package's
bilinear_scatter_adjoint_device (without a gain) and the image cotangent of
its weighted gather (with one), under x64, to 1e-12 of scale (the same
products, summed in another order), fresh and into an output.  Positions
are float64 or float32 (widened, exactly), on small grids: rolls of 0-180
degrees, scales 0.8 and 1.25, shifts, NaN rows, queries off the grid, and
an output whose last tiles are ragged.  A map shrunk 0.1x (SHRUNK) spreads
a tile's queries over more query rows than the plan kernel's ring holds:
its plan counts those tiles as overflowed, and K4 takes the off-plan body
there (bilinear_cuda.plan_route), whose plain version is held to the JAX
adjoint.  A NaN position adds nothing in the port and NaN in the JAX
package, so the JAX calls take such a query off the grid instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyimcom_tpu.ops import bilinear as ref_bil
from pyimcom_tpu.ops import destripe_device as ref_dd
from pyimcom_tpu_torch.ops import bilinear
from pyimcom_tpu_torch.ops import bilinear_cuda as bc
from pyimcom_tpu_torch.ops import destripe_device
from pyimcom_tpu_torch.ops.destripe_device import DestripeCost
from k4_plan_torch import BAND, CHUNK, TILE, planned_adjoint, tile_windows, unpack

torch.set_num_threads(1)
TOL = 1e-12
NY, NX, QNY, QNX = 100, 93, 90, 97          # ragged against 32 x 32 tiles
KINDS = ("roll0", "roll15", "roll45", "roll90", "roll180", "scale0.8", "scale1.25", "shift",
         "nan_rows", "off_grid")
DTYPES = {"f64": torch.float64, "f32": torch.float32}
# a map shrunk 0.1x and rolled by 30 degrees: 400 x 60 queries on a 64 x 64
# output, a tile's queries over ~300 query rows
SHRUNK, SHRUNK_GRID = "shrunk0.1", (400, 60, 64, 64)


def _grid(kind):
    """(qny, qnx, ny, nx) of a case."""
    return SHRUNK_GRID if kind == SHRUNK else (QNY, QNX, NY, NX)


def _positions(kind, seed=0, qny=QNY, qnx=QNX, ny=NY, nx=NX):
    """A pair-map-like (qny, qnx) query grid on a (ny, nx) output: the grid
    rolled, scaled and shifted about the output's centre (SHRUNK: its own
    grid, scaled about the output's corner)."""
    if kind == SHRUNK:
        th = np.deg2rad(30)
        yy, xx = np.mgrid[0:SHRUNK_GRID[0], 0:SHRUNK_GRID[1]].astype(float)
        return (0.1 * (np.cos(th) * xx - np.sin(th) * yy) + 30.3,
                0.1 * (np.sin(th) * xx + np.cos(th) * yy) + 5.2)
    rng = np.random.default_rng(seed)
    roll = int(kind[4:]) if kind.startswith("roll") else 30
    scale = float(kind[5:]) if kind.startswith("scale") else 1.0
    sx, sy = {"shift": (17.6, -11.2), "off_grid": (48.3, 30.1)}.get(kind, (0.4, -0.3))
    th = np.deg2rad(roll)
    yy, xx = np.mgrid[0:qny, 0:qnx].astype(float)
    u, w = xx - qnx / 2, yy - qny / 2
    xf = scale * (np.cos(th) * u - np.sin(th) * w) + nx / 2 + sx + rng.uniform(-0.05, 0.05)
    yf = scale * (np.sin(th) * u + np.cos(th) * w) + ny / 2 + sy + rng.uniform(-0.05, 0.05)
    if kind == "nan_rows":
        xf[10:13, :] = np.nan
        yf[40, ::3] = np.nan
        xf[60:, 50:] = np.nan
    if kind == "off_grid":
        for pos, last in ((xf, nx - 1.0), (yf, ny - 1.0)):
            near = np.abs(pos - last) < 0.5
            near[1::3] = False
            pos[near] = last
    return xf, yf


def _case(kind, dtype, seed=0):
    qny, qnx, ny, nx = _grid(kind)
    xf, yf = _positions(kind, seed)
    rng = np.random.default_rng(seed + 1)
    x = torch.as_tensor(xf).to(DTYPES[dtype])
    y = torch.as_tensor(yf).to(DTYPES[dtype])
    return (x, y, torch.as_tensor(rng.normal(size=(qny, qnx))),
            torch.as_tensor(rng.uniform(0.5, 2.0, (ny, nx))),
            torch.as_tensor(rng.normal(size=(ny, nx))))


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _brute_plan(x, y, shape):
    """For each tile, the (rows, columns) of the queries that add into it,
    by a loop over the tiles in NumPy."""
    ny, nx = shape
    fx, fy = np.floor(x.double().numpy()), np.floor(y.double().numpy())
    with np.errstate(invalid="ignore"):
        inb = (fx >= 0) & (fx < nx - 1) & (fy >= 0) & (fy < ny - 1)
        out = []
        for ty in range(-(-ny // TILE)):
            for tx in range(-(-nx // TILE)):
                m = (inb & (fy >= TILE * ty - 1) & (fy <= TILE * ty + TILE - 1)
                     & (fx >= TILE * tx - 1) & (fx <= TILE * tx + TILE - 1))
                out.append(np.nonzero(m))
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_plan_complete_and_tight(kind, dtype):
    """Each tile's plan against the brute-force loop: its first and last
    query rows, each band's columns (an empty band where none of its rows
    holds a query), the incidences and the staged window; the queries the
    kernel stages hold each contributing one exactly once."""
    x, y, *_ = _case(kind, dtype)
    plan = bc.build_adjoint_plan(x, y, (NY, NX))
    assert plan.shape == (NY, NX) and plan.grid == (QNY, QNX)
    assert plan.rows.dtype == plan.ptr.dtype == plan.spans.dtype == torch.int32
    brute = _brute_plan(x, y, (NY, NX))
    assert len(plan.ptr) == len(brute) + 1
    pairs = window = 0
    for t, (r, c) in enumerate(brute):
        nb = int(plan.ptr[t + 1] - plan.ptr[t])
        if len(r) == 0:
            assert nb == 0 and plan.rows[t].tolist() == [0, -1]
            continue
        pairs += len(r)
        lo_row, hi_row = int(r.min()), int(r.max())
        assert plan.rows[t].tolist() == [lo_row, hi_row]
        assert nb == (hi_row - lo_row) // BAND + 1
        for k in range(nb):
            first, last = lo_row + BAND * k, min(lo_row + BAND * k + BAND - 1, hi_row)
            lo, hi = unpack(plan.spans[int(plan.ptr[t]) + k])
            cols = c[(r >= first) & (r <= last)]
            if len(cols):
                assert (lo, hi) == (int(cols.min()), int(cols.max()))
                window += (last - first + 1) * (hi - lo + 1)
            else:
                assert lo > hi
        staged = tile_windows(plan, t)
        assert len(torch.unique(staged)) == len(staged) == int(plan.tile_windows()[t])
        assert set((r * QNX + c).tolist()) <= set(staged.tolist())
    assert plan.pairs == pairs and plan.window == window
    assert plan.r >= 1.0 and plan.nbytes == 4 * (3 * len(brute) + 1 + len(plan.spans))
    if kind in ("roll0", "roll45", "scale1.25"):
        assert pairs > 5000 and plan.r < 1.3


def _ring_plan(x, y, shape, seg_q=256):
    """The plan kernel's one pass, mirrored in NumPy (csrc/bilinear.cu,
    plan_pass_kernel, plan_counts_kernel, plan_spans_kernel): each query's
    four slot tiles; along each row, in segments of `seg_q` queries whose
    ends count as run ends, a run's first column into the tile's ring entry
    of the row (row mod PLAN_RING_ROWS) and the row into the tile's first
    and last row, its last column into the ring's other side (a slot-0 or
    1 run's start left to the slot-2 or 3 run of its tile just before it,
    a slot-2 or 3 run's end to the slot-0 or 1 run just after); then each
    tile's band count (none where its rows span the ring: overflowed), the
    scan, and each band's span from the extremes of its rows' entries.
    Returns (rows, ptr, spans, pairs, window, overflowed tiles)."""
    ny, nx = shape
    R = bc.PLAN_RING_ROWS
    qny, qnx = x.shape
    tx_n = -(-nx // TILE)
    T = -(-ny // TILE) * tx_n
    big = 0x7F7F7F7F
    row_lo, row_hi = np.full(T, big, np.int64), np.full(T, -1, np.int64)
    ring_lo, ring_hi = np.full((T, R), big, np.int64), np.full((T, R), -1, np.int64)
    with np.errstate(invalid="ignore"):
        fx, fy = np.floor(x.double().numpy()), np.floor(y.double().numpy())
        inb = (fx >= 0) & (fx < nx - 1) & (fy >= 0) & (fy < ny - 1)
    ix, iy = np.where(inb, fx, 0).astype(np.int64), np.where(inb, fy, 0).astype(np.int64)
    ty0, tx0, ty1, tx1 = iy // TILE, ix // TILE, (iy + 1) // TILE, (ix + 1) // TILE
    down, right = ty1 != ty0, tx1 != tx0
    slots = [np.where(keep, ty * tx_n + tx, -1) for ty, tx, keep in (
        (ty0, tx0, inb), (ty1, tx0, inb & down), (ty0, tx1, inb & right),
        (ty1, tx1, inb & down & right))]
    pairs = int(sum((t >= 0).sum() for t in slots))
    cols = np.arange(qnx)
    lefts, rights = [], []
    for t in slots:
        left = np.concatenate([np.full((qny, 1), -2), t[:, :-1]], 1)
        rgt = np.concatenate([t[:, 1:], np.full((qny, 1), -2)], 1)
        left[:, cols % seg_q == 0] = -2
        rgt[:, (cols + 1) % seg_q == 0] = -2
        lefts.append(left)
        rights.append(rgt)
    for k, t in enumerate(slots):
        left, rgt = lefts[k], rights[k]
        # a slot-0 (1) run after the left neighbour's slot-2 (3) run of its
        # tile leaves its start to it; a slot-2 (3) run before the right
        # neighbour's slot-0 (1) run of its tile leaves its end to it
        skip_st = lefts[k + 2] == t if k < 2 else np.zeros_like(t, bool)
        skip_en = rights[k - 2] == t if k >= 2 else np.zeros_like(t, bool)
        for qr in range(qny):
            tr = t[qr]
            st = (tr >= 0) & (tr != left[qr]) & ~skip_st[qr]
            en = (tr >= 0) & (tr != rgt[qr]) & ~skip_en[qr]
            np.minimum.at(ring_lo[:, qr % R], tr[st], cols[st])
            np.minimum.at(row_lo, tr[st], qr)
            np.maximum.at(row_hi, tr[st], qr)
            np.maximum.at(ring_hi[:, qr % R], tr[en], cols[en])
    live = row_hi >= 0
    over = live & (row_hi - row_lo >= R)
    nb = np.where(live & ~over, (row_hi - row_lo) // BAND + 1, 0)
    ptr = np.concatenate([[0], np.cumsum(nb)])
    spans, window = [], 0
    for t in range(T):
        for k in range(nb[t]):
            first = row_lo[t] + BAND * k
            last = min(first + BAND - 1, row_hi[t])
            rr = np.arange(first, last + 1) % R
            a, z = ring_lo[t, rr].min(), ring_hi[t, rr].max()
            if z < 0:
                a, z = 0xFFFF, 0
            else:
                window += (last - first + 1) * (z - a + 1)
            spans.append(int(a) | (int(z) << 16))
    rows = np.stack([np.where(live, row_lo, 0), np.where(live, row_hi, -1)], 1)
    spans = np.asarray(spans, np.int64)
    return rows, ptr, np.where(spans >= 2 ** 31, spans - 2 ** 32, spans), pairs, window, \
        int(over.sum())


@pytest.mark.parametrize("kind", KINDS)
def test_one_pass_ring_build_gives_the_plan(kind):
    """The plan kernel's one pass over the positions (a tile's columns a
    row in a ring, bands from the ring; mirrored by _ring_plan) gives the
    plain builder's plan word for word, in segments of 256 queries and, to
    cut runs at many more places, of 7."""
    x, y, *_ = _case(kind, "f64")
    want = bc.build_adjoint_plan_plain(x, y, (NY, NX))
    for seg_q in (256, 7):
        rows, ptr, spans, pairs, window, over = _ring_plan(x, y, (NY, NX), seg_q)
        assert over == 0
        np.testing.assert_array_equal(rows, want.rows.numpy())
        np.testing.assert_array_equal(ptr, want.ptr.numpy())
        np.testing.assert_array_equal(spans, want.spans.numpy())
        assert (pairs, window) == (want.pairs, want.window)
        assert int(want.meta[1]) == len(spans) == want.bands


def test_plan_of_a_shrunk_map_raises():
    """A map shrunk 0.1x puts a tile's queries over more rows than the
    kernel's ring holds (the name is from when the plan raised there): the
    ring build flags those tiles and gives them no band, and the plain
    builder's plan, at either position width, equals it word for word,
    counts them in `over` (tiles with queries and no band) and sends K4 to
    the off-plan body (plan_route)."""
    shape = SHRUNK_GRID[2:]
    for dtype in DTYPES:
        x, y, *_ = _case(SHRUNK, dtype)
        rows, ptr, spans, pairs, window, over = _ring_plan(x, y, shape)
        plan = bc.build_adjoint_plan_plain(x, y, shape)
        assert over > 0 and plan.over == over
        assert bc.plan_route(plan) == "stream"
        np.testing.assert_array_equal(rows, plan.rows.numpy())
        np.testing.assert_array_equal(ptr, plan.ptr.numpy())
        np.testing.assert_array_equal(spans, plan.spans.numpy())
        assert (pairs, window, len(spans)) == (plan.pairs, plan.window, plan.bands)
        flagged = (plan.rows[:, 1] >= 0) & (plan.ptr[1:] == plan.ptr[:-1])
        assert int(flagged.sum()) == over
        assert bool(((plan.rows[:, 1] - plan.rows[:, 0])[flagged] >= bc.PLAN_RING_ROWS).all())


def _jax_adjoint(x, y, values, gain, shape):
    """The JAX package's adjoint under x64 (the weighted gather's image
    cotangent with a gain); a NaN position taken off the grid."""
    xj = np.where(np.isnan(x.double().numpy()), -5.0, x.double().numpy())
    yj = np.where(np.isnan(y.double().numpy()), -5.0, y.double().numpy())
    v = jnp.asarray(values.numpy())
    if gain is None:
        return np.asarray(ref_bil.bilinear_scatter_adjoint_device(v, jnp.asarray(xj),
                                                                  jnp.asarray(yj), shape))
    ge = jnp.asarray(gain.numpy())
    _, vjp = jax.vjp(lambda im: ref_dd._gather_weighted(im, ge, jnp.asarray(xj),
                                                         jnp.asarray(yj))[0],
                     jnp.zeros(shape, jnp.float64))
    return np.asarray(vjp(v)[0])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS + (SHRUNK,))
def test_planned_traversal_matches_plain_and_jax(kind, dtype):
    """The emulated traversal, with and without a gain, fresh and added into
    an output, against bilinear_scatter_adjoint_plain and the JAX package's
    adjoint, to 1e-12 of scale.  The shrunk map's plan overflows, so K4
    takes the off-plan body there: its plain version is held to the JAX
    adjoint."""
    x, y, v, gain, base = _case(kind, dtype)
    shape = _grid(kind)[2:]
    assert int(bilinear.in_bounds(x, y, shape).sum()) > 2000
    plan = bc.build_adjoint_plan(x, y, shape)
    assert bc.plan_route(plan) == ("stream" if kind == SHRUNK else "planned")
    for g in (None, gain):
        want = bilinear.bilinear_scatter_adjoint_plain(v, x, y, shape, g)
        jax_want = torch.as_tensor(np.array(_jax_adjoint(x, y, v, g, shape)))
        if kind == SHRUNK:
            # the off-plan body's plain version
            assert _rel(want, jax_want) < TOL
        else:
            got = planned_adjoint(v, x, y, shape, plan, g)
            assert _rel(got, want) < TOL
            assert _rel(got, jax_want) < TOL
            into = planned_adjoint(v, x, y, shape, plan, g, out=base.clone())
            assert _rel(into, base + want) < TOL
        # the dispatch on a CPU tensor is the plain version, plan or none
        assert torch.equal(bilinear.bilinear_scatter_adjoint(v, x, y, shape, g, plan=plan),
                           want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_large_windows_stream_through_chunks(dtype):
    """A map at a scale of 0.3 puts ~11000 queries and up to 37 bands in a
    tile's window: the traversal takes it in band groups and chunks (the
    kernel's, and chunks of 100), and still equals the plain adjoint."""
    xf, yf = _positions("roll45", 3, qny=150, qnx=150, ny=45, nx=40)
    xf, yf = 0.3 * (xf - 20) + 20, 0.3 * (yf - 22.5) + 22.5
    x, y = torch.as_tensor(xf).to(DTYPES[dtype]), torch.as_tensor(yf).to(DTYPES[dtype])
    rng = np.random.default_rng(4)
    v = torch.as_tensor(rng.normal(size=(150, 150)))
    gain = torch.as_tensor(rng.uniform(0.5, 2.0, (45, 40)))
    plan = bc.build_adjoint_plan(x, y, (45, 40))
    nb = plan.ptr[1:] - plan.ptr[:-1]
    assert int(nb.max()) > 16 and max(len(tile_windows(plan, t)) for t in range(4)) > 8000
    want = bilinear.bilinear_scatter_adjoint_plain(v, x, y, (45, 40), gain)
    for chunk in (CHUNK, 100):
        assert _rel(planned_adjoint(v, x, y, (45, 40), plan, gain, chunk=chunk), want) < TOL


@pytest.mark.parametrize("map_dtype", ["f64", "f32"])
def test_destripe_cost_plans_equal_across_storage(map_dtype, monkeypatch):
    """DestripeCost builds one plan a pair in the walk that counts the hits,
    on a CUDA device (here the builder is called on the CPU too, in its
    place): equal for maps on the device and streamed from host memory, and
    equal to build_adjoint_plan of the stored maps.  On the CPU itself it
    builds none: the plain adjoint takes no plan."""
    rng = np.random.default_rng(7)
    S, n = 3, 70
    yy, xx = np.mgrid[0:n, 0:n].astype(float)
    pairs, xf, yf = [], [], []
    for i in range(S):
        for j in range(S):
            if i != j:
                th = 0.2 * (i - j)
                pairs.append((i, j))
                xf.append(np.cos(th) * xx - np.sin(th) * yy + 5.3 * (i - j))
                yf.append(np.sin(th) * xx + np.cos(th) * yy - 3.1 * (i - j))
    args = (rng.normal(size=(S, n, n)), rng.uniform(0.5, 2.0, (S, n, n)), None, pairs, xf, yf)
    assert DestripeCost(*args, device="cpu", map_dtype=map_dtype).plans == [None] * len(pairs)
    monkeypatch.setattr(destripe_device, "_pair_plan", bc.build_adjoint_plan)
    dev = DestripeCost(*args, device="cpu", map_dtype=map_dtype)
    host = DestripeCost(*args, device="cpu", map_dtype=map_dtype, map_store="host")
    assert len(dev.plans) == len(host.plans) == len(pairs)
    for p, (a, b) in enumerate(zip(dev.plans, host.plans)):
        want = bc.build_adjoint_plan(dev.xf[p], dev.yf[p], (n, n))
        for plan in (a, b):
            for name in ("rows", "ptr", "spans"):
                assert torch.equal(getattr(plan, name), getattr(want, name))
            assert (plan.pairs, plan.window, plan.grid) == (want.pairs, want.window, (n, n))
        assert a.pairs > 1000


@pytest.mark.parametrize("map_dtype, map_store", [("f64", "device"), ("f32", "host")])
def test_destripe_cost_with_a_shrunk_pair(map_dtype, map_store, monkeypatch):
    """A DestripeCost holding a pair whose plan overflows (a map shrunk
    0.1x), its plans built as on a CUDA device (the builder called on the
    CPU in their place): nothing raises, the build reads every plan's
    counts back in one call of check_plans and the costs read none, the
    shrunk pair's route is the off-plan body and the other pair's the
    planned one; on the CPU the adjoint is the plain version whatever the
    plan, so cost and gradient are those of the module without plans, and
    within the destripe bounds of its plain route."""
    rng = np.random.default_rng(8)
    n = 320
    yy, xx = np.mgrid[0:n, 0:n].astype(float)
    th = np.deg2rad(30)
    # pair (0, 1) rolled 0.01 rad and shifted; pair (1, 0) shrunk 0.1x and
    # rolled 30 degrees, a tile's queries over ~440 query rows
    xf = [np.cos(0.01) * xx - np.sin(0.01) * yy + 2.3,
          0.1 * (np.cos(th) * xx - np.sin(th) * yy) + 100.3]
    yf = [np.sin(0.01) * xx + np.cos(0.01) * yy - 1.7,
          0.1 * (np.sin(th) * xx + np.cos(th) * yy) + 100.2]
    pairs = [(0, 1), (1, 0)]
    args = (rng.normal(size=(2, n, n)), rng.uniform(0.5, 2.0, (2, n, n)),
            rng.random((2, n, n)) > 0.1, pairs, xf, yf)
    kw = dict(amp_cols=64, col_boundary_const=2.0, device="cpu", map_dtype=map_dtype,
              map_store=map_store)
    bare = DestripeCost(*args, **kw)
    assert bare.plans == [None, None]
    calls = []

    def counted(plans):
        calls.append(len(plans))
        bc.check_plans(plans)

    monkeypatch.setattr(destripe_device, "_pair_plan", bc.build_adjoint_plan)
    monkeypatch.setattr(destripe_device, "check_plans", counted)
    dc = DestripeCost(*args, **kw)
    assert calls == [2] and all("_counts" in pl.__dict__ for pl in dc.plans)
    assert [bc.plan_route(pl) for pl in dc.plans] == ["planned", "stream"]
    assert dc.plans[1].over > 0 and dc.plans[0].over == 0
    p = rng.normal(scale=0.01, size=2 * dc.np_each)
    cost, grad = dc.cost_and_grad(p)
    assert dc.cost(p) == cost and calls == [2]
    want_cost, want_grad = bare.cost_and_grad(p)
    assert cost == want_cost and np.array_equal(grad, want_grad)
    e, g = dc.value_and_grad(torch.as_tensor(p), plain=True)
    np.testing.assert_allclose(float(e), cost, rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), grad, rtol=1e-9, atol=1e-12)


def _off_plan_reference(xf, yf, shape):
    """The off-plan body's tiles holding a query in bounds, by a loop: none
    on a grid whose plan (the ring build, _ring_plan) did not overflow."""
    ny, nx = shape
    x = xf.reshape(-1, xf.shape[-1]) if xf.ndim >= 2 else xf.reshape(1, -1)
    y = yf.reshape(x.shape)
    if (x.shape[0] > 1 and x.shape[1] <= bc.PLAN_MAX_COLS
            and _ring_plan(torch.as_tensor(x), torch.as_tensor(y), shape)[-1] == 0):
        return 0
    th, tw = (1, 1024) if x.shape[0] == 1 else (32, 32)
    n = 0
    for r0 in range(0, x.shape[0], th):
        for c0 in range(0, x.shape[1], tw):
            fx, fy = np.floor(x[r0:r0 + th, c0:c0 + tw]), np.floor(y[r0:r0 + th, c0:c0 + tw])
            with np.errstate(invalid="ignore"):
                n += bool(((fx >= 0) & (fx < nx - 1) & (fy >= 0) & (fy < ny - 1)).any())
    return n


@pytest.mark.parametrize("case", ["stream", "one_row", "grid", "wide", SHRUNK])
def test_predict_off_plan_tiles(case):
    """predict_off_plan_tiles (the K4 tiles off the planned route, which
    chip_smoke.py holds the card's count to) against its definition: a
    planned grid has none; a stream, a one-row grid, a grid wider than
    PLAN_MAX_COLS and a grid whose plan overflowed (the shrunk map) count
    each of their tiles holding a query in bounds; given the grid's plan,
    the same count."""
    rng = np.random.default_rng(9)
    shape = _grid(case)[2:]
    if case == SHRUNK:
        xf, yf = _positions(SHRUNK)
    elif case == "wide":
        xf = rng.uniform(-20, 120, (2, bc.PLAN_MAX_COLS + 500))
        yf = rng.uniform(-20, 120, xf.shape)
        xf[:, :40000] = -7.0                 # tiles with no query in bounds
    else:
        xf, yf = _positions("roll15", 5)
        if case == "stream":
            xf, yf = xf.ravel(), yf.ravel()
            xf[:3000] = np.nan
        elif case == "one_row":
            xf, yf = xf[:1], yf[:1]
    xt, yt = torch.as_tensor(xf), torch.as_tensor(yf)
    got = bc.predict_off_plan_tiles(xt, yt, shape)
    assert got == _off_plan_reference(xf, yf, shape)
    assert (got > 0) == (case != "grid")
    if case in ("grid", SHRUNK):
        # the caller's plan of these positions in place of the builder's
        plan = bc.build_adjoint_plan(xt, yt, shape)
        assert bc.predict_off_plan_tiles(xt, yt, shape, plan) == got
