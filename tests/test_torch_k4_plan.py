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
an output whose last tiles are ragged.  A NaN position adds nothing in the
port and NaN in the JAX package, so the JAX calls take such a query off the
grid instead.
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


def _positions(kind, seed=0, qny=QNY, qnx=QNX, ny=NY, nx=NX):
    """A pair-map-like (qny, qnx) query grid on a (ny, nx) output: the grid
    rolled, scaled and shifted about the output's centre."""
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
    xf, yf = _positions(kind, seed)
    rng = np.random.default_rng(seed + 1)
    x = torch.as_tensor(xf).to(DTYPES[dtype])
    y = torch.as_tensor(yf).to(DTYPES[dtype])
    return (x, y, torch.as_tensor(rng.normal(size=(QNY, QNX))),
            torch.as_tensor(rng.uniform(0.5, 2.0, (NY, NX))),
            torch.as_tensor(rng.normal(size=(NY, NX))))


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
@pytest.mark.parametrize("kind", KINDS)
def test_planned_traversal_matches_plain_and_jax(kind, dtype):
    """The emulated traversal, with and without a gain, fresh and added into
    an output, against bilinear_scatter_adjoint_plain and the JAX package's
    adjoint, to 1e-12 of scale."""
    x, y, v, gain, base = _case(kind, dtype)
    assert int(bilinear.in_bounds(x, y, (NY, NX)).sum()) > 2000
    plan = bc.build_adjoint_plan(x, y, (NY, NX))
    for g in (None, gain):
        want = bilinear.bilinear_scatter_adjoint_plain(v, x, y, (NY, NX), g)
        got = planned_adjoint(v, x, y, (NY, NX), plan, g)
        assert _rel(got, want) < TOL
        assert _rel(got, torch.as_tensor(np.array(_jax_adjoint(x, y, v, g, (NY, NX))))) < TOL
        into = planned_adjoint(v, x, y, (NY, NX), plan, g, out=base.clone())
        assert _rel(into, base + want) < TOL
        # the dispatch on a CPU tensor is the plain version, plan or none
        assert torch.equal(bilinear.bilinear_scatter_adjoint(v, x, y, (NY, NX), g, plan=plan),
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


def _off_plan_reference(xf, yf, shape):
    """The off-plan body's tiles holding a query in bounds, by a loop."""
    ny, nx = shape
    x = xf.reshape(-1, xf.shape[-1]) if xf.ndim >= 2 else xf.reshape(1, -1)
    y = yf.reshape(x.shape)
    if x.shape[0] > 1 and x.shape[1] <= bc.PLAN_MAX_COLS:
        return 0
    th, tw = (1, 1024) if x.shape[0] == 1 else (32, 32)
    n = 0
    for r0 in range(0, x.shape[0], th):
        for c0 in range(0, x.shape[1], tw):
            fx, fy = np.floor(x[r0:r0 + th, c0:c0 + tw]), np.floor(y[r0:r0 + th, c0:c0 + tw])
            with np.errstate(invalid="ignore"):
                n += bool(((fx >= 0) & (fx < nx - 1) & (fy >= 0) & (fy < ny - 1)).any())
    return n


@pytest.mark.parametrize("case", ["stream", "one_row", "grid", "wide"])
def test_predict_off_plan_tiles(case):
    """predict_off_plan_tiles (the K4 tiles off the planned route, which
    chip_smoke.py holds the card's count to) against its definition: a
    planned grid has none; a stream, a one-row grid and a grid wider than
    PLAN_MAX_COLS count each of their tiles holding a query in bounds."""
    rng = np.random.default_rng(9)
    if case == "wide":
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
    got = bc.predict_off_plan_tiles(torch.as_tensor(xf), torch.as_tensor(yf), (NY, NX))
    assert got == _off_plan_reference(xf, yf, (NY, NX))
    assert (got > 0) == (case != "grid")
