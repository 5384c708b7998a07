"""pyimcom_tpu_torch's destriping against the JAX package's.

The same seeded numpy arrays go through both packages in float64 on the
CPU: the bilinear pair (the port's plain versions of K3 and K4 against
pyimcom_tpu/ops/bilinear.py), the device-resident cost and gradient
(the port's DestripeCost against the JAX DeviceDestripe, and against the
JAX host route with uniform gain), conjugate gradient, and `main` on
FITS SCAs.

Bounds: the gathers agree to atol 1e-12 (the same arithmetic, another
summation order in the adjoint); the cost to rtol 1e-12 and the gradient
to rtol 1e-9, atol 1e-12 (the JAX package's own bounds between its routes,
tests/test_imdestripe.py); five CG steps to 1e-8 of the parameters' scale
(the steps amplify the rounding differences of the gradients).  A NaN
position gives 0 in the port and adds nothing to its adjoint, where the
JAX package gives NaN, so those points are compared with 0 and left out
of the JAX adjoint.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyimcom_tpu import imdestripe as ref
from pyimcom_tpu.config import Config as RefConfig
from pyimcom_tpu.ops import bilinear as ref_bil
from pyimcom_tpu.wcsutil import WCS as RefWCS
from pyimcom_tpu_torch import imdestripe
from pyimcom_tpu_torch.config import Config
from pyimcom_tpu_torch.fitsio import HDUList, Header, ImageHDU, fits_read, fits_write
from pyimcom_tpu_torch.ops import bilinear
from pyimcom_tpu_torch.ops.destripe_device import DestripeCost
from pyimcom_tpu_torch.wcsutil import WCS

torch.set_num_threads(1)
CPU = torch.device("cpu")
SIZE = 100
WCS_ARGS = dict(ctype=("RA---TAN", "DEC--TAN"), crval=(150.0, 2.0),
                cd=np.array([[-4e-5, 0], [0, 4e-5]]), lonpole=180.0)
DITHERS = [(0, 0), (11, 4), (5, 13)]
NEIGHBORS = {0: [1, 2], 1: [0, 2], 2: [0, 1]}


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64), device=CPU)


# --------------------------------------------------------------------------
# the bilinear pair
# --------------------------------------------------------------------------

def _points(seed, ny=40, nx=37, n=600):
    """A seeded image, gain, values and n points: inside, off the grid (up
    to 3 pixels past each edge, exact integers and the last row/column
    included) and NaN in x, y or both."""
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(ny, nx))
    gain = rng.uniform(0.5, 2.0, (ny, nx))
    xf = rng.uniform(-3, nx + 2, n)
    yf = rng.uniform(-3, ny + 2, n)
    xf[:20] = np.arange(20) % nx                      # integer positions
    yf[20:30] = ny - 1.0                               # on the last row: out
    xf[30:40], yf[40:50] = np.nan, np.nan
    xf[50:55] = yf[50:55] = np.nan
    nan = np.isnan(xf) | np.isnan(yf)
    return img, gain, xf, yf, rng.normal(size=n), nan


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_plain_gather_matches_jax(weighted):
    img, gain, xf, yf, _v, nan = _points(1)
    g = gain if weighted else None
    got = bilinear.bilinear_gather_plain(_t(img), _t(xf), _t(yf), None if g is None else _t(g))
    if weighted:
        want = ref_bil.bilinear_gather_weighted_device(*map(jnp.asarray, (img, xf, yf, gain)))
    else:
        want = ref_bil.bilinear_gather_device(*map(jnp.asarray, (img, xf, yf)))
    got, want = got.numpy(), np.asarray(want)
    assert np.all(got[nan] == 0) and np.any(np.isnan(want[nan]))
    np.testing.assert_allclose(got[~nan], want[~nan], rtol=0, atol=1e-12)
    assert np.count_nonzero(got) > 300


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_plain_adjoint_matches_jax(weighted):
    """The port's adjoint (NaN points included) against the JAX adjoint of
    the points that are not NaN: the scatter-add without a gain, and the
    image cotangent of the weighted gather (jax.vjp) with one."""
    img, gain, xf, yf, v, nan = _points(2)
    g = gain if weighted else None
    got = bilinear.bilinear_scatter_adjoint_plain(_t(v), _t(xf), _t(yf), img.shape,
                                                  None if g is None else _t(g)).numpy()
    ok = ~nan
    x, y, vv = (jnp.asarray(a[ok]) for a in (xf, yf, v))
    if weighted:
        _out, vjp = jax.vjp(lambda im: ref_bil.bilinear_gather_weighted_device(
            im, x, y, jnp.asarray(gain)), jnp.asarray(img))
        want = vjp(vv)[0]
    else:
        want = ref_bil.bilinear_scatter_adjoint_device(vv, x, y, img.shape)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-12)


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_plain_pair_is_an_exact_adjoint(weighted):
    """<gather(u), v> == <u, adjoint(v)> (reference test_imdestripe.py:258)."""
    img, gain, xf, yf, v, _nan = _points(3)
    g = _t(gain) if weighted else None
    lhs = float(torch.dot(bilinear.bilinear_gather_plain(_t(img), _t(xf), _t(yf), g), _t(v)))
    rhs = float(torch.sum(_t(img) * bilinear.bilinear_scatter_adjoint_plain(
        _t(v), _t(xf), _t(yf), img.shape, g)))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


@pytest.mark.parametrize("case", ["plain", "weighted", "accumulate"])
def test_bilinear_gather_gradcheck(case):
    """BilinearGather's backward is the Jacobian of its forward with respect
    to the image (and the identity with respect to the accumulator)."""
    img, gain, xf, yf, _v, _nan = _points(4, ny=6, nx=7, n=40)
    x, y = _t(xf), _t(yf)
    g = _t(gain) if case == "weighted" else None
    image = _t(img).requires_grad_(True)
    if case == "accumulate":
        acc = _t(np.random.default_rng(5).normal(size=40)).requires_grad_(True)
        assert torch.autograd.gradcheck(
            lambda im, a: bilinear.BilinearGather.apply(im, x, y, g, a.clone()), (image, acc))
    else:
        assert torch.autograd.gradcheck(
            lambda im: bilinear.BilinearGather.apply(im, x, y, g), (image,))


def test_dispatch_on_the_cpu_and_accumulate():
    """On a CPU tensor the public functions are the plain versions; `out`
    adds into the caller's accumulator; another device raises."""
    img, gain, xf, yf, v, _nan = _points(6)
    want = bilinear.bilinear_gather_plain(_t(img), _t(xf), _t(yf), _t(gain))
    assert torch.equal(bilinear.bilinear_gather(_t(img), _t(xf), _t(yf), _t(gain)), want)
    acc = _t(v).clone()
    out = bilinear.bilinear_gather(_t(img), _t(xf), _t(yf), _t(gain), out=acc)
    assert out is acc and torch.equal(acc, _t(v) + want)
    assert torch.equal(bilinear.bilinear_scatter_adjoint(_t(v), _t(xf), _t(yf), img.shape),
                       bilinear.bilinear_scatter_adjoint_plain(_t(v), _t(xf), _t(yf),
                                                               img.shape))
    meta = torch.empty((4, 4), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bilinear.bilinear_gather(meta, meta[0], meta[0])


@pytest.mark.parametrize("case", ["plain", "weighted", "accumulate"])
def test_bilinear_gather_on_a_grid_matches_flat_positions(case):
    """Positions, values and accumulator on a (ny, nx) query grid (the layout
    that K4 tiles on the card) give the flat route's gather and image
    gradient, bit for bit."""
    img, gain, xf, yf, v, _nan = _points(7, n=600)
    g = _t(gain) if case == "weighted" else None
    out, grads = {}, {}
    for shape in ((20, 30), (600,)):
        x, y, vv = (_t(a).reshape(shape) for a in (xf, yf, v))
        image = _t(img).requires_grad_(True)
        acc = _t(np.arange(600.0).reshape(shape)) if case == "accumulate" else None
        got = bilinear.BilinearGather.apply(image, x, y, g, acc)
        assert got.shape == shape
        (grads[shape],) = torch.autograd.grad(got, image, vv)
        out[shape] = got.detach().reshape(-1)
    assert torch.equal(out[(20, 30)], out[(600,)])
    assert torch.equal(grads[(20, 30)], grads[(600,)])


def _global_tiles_reference(xf, yf, shape, tile, max_cols):
    """K4's tiles off the planned route by a loop over the tiles in NumPy:
    none on a grid of more than one row and at most `max_cols` columns;
    else each `tile` of the off-plan body that holds a query in bounds."""
    ny, nx = shape
    x = xf.reshape(-1, xf.shape[-1]) if xf.ndim >= 2 else xf.reshape(1, -1)
    y = yf.reshape(x.shape)
    if x.shape[0] > 1 and x.shape[1] <= max_cols:
        return 0
    th, tw = tile
    n = 0
    for r0 in range(0, x.shape[0], th):
        for c0 in range(0, x.shape[1], tw):
            fx, fy = np.floor(x[r0:r0 + th, c0:c0 + tw]), np.floor(y[r0:r0 + th, c0:c0 + tw])
            with np.errstate(invalid="ignore"):
                ok = (fx >= 0) & (fx < nx - 1) & (fy >= 0) & (fy < ny - 1)
            n += bool(ok.any())
    return n


@pytest.mark.parametrize("case", ["roll15", "roll45", "scale2.5", "one_row", "holes"])
def test_predict_global_tiles(case):
    """bilinear_cuda.predict_off_plan_tiles (the K4 tiles off the planned
    route, which chip_smoke.py holds the card's count to) against a loop
    over the tiles, on each case's 2-D grid and on its flattened stream: a
    pair-like grid at any roll or scale has none (the tiled body sent the
    scaled grid's tiles and the far query's to its global route; the plan
    takes them); a stream counts its tiles that hold a query in bounds."""
    from pyimcom_tpu_torch.ops import bilinear_cuda as bc

    rng = np.random.default_rng(8)
    ny, nx, qny, qnx = 300, 280, 150, 173
    roll, scale = {"roll45": 45, "scale2.5": 30}.get(case, 15), 2.5 if case == "scale2.5" else 1
    th = np.deg2rad(roll)
    yy, xx = np.mgrid[0:qny, 0:qnx].astype(float) - np.array([qny, qnx])[:, None, None] / 2
    xf = scale * (np.cos(th) * xx - np.sin(th) * yy) + nx / 2 + 40.3
    yf = scale * (np.sin(th) * xx + np.cos(th) * yy) + ny / 2 + 0.6
    if case == "holes":
        xf[rng.random(xf.shape) < 0.3] = np.nan
        xf[:40, :40] = -5.0                  # tiles with no query in bounds
        xf[100, 100] = 3.0                   # one query far from its tile's
    grids = [(xf, yf), (xf.ravel(), yf.ravel())]
    if case == "one_row":
        grids = [(xf[:1], yf[:1]), (xf.ravel(), yf.ravel())]
    for x, y in grids:
        qrows = bc.query_grid(_t(x))[0]
        tile = bc.ADJOINT_ROW_TILE if qrows == 1 else bc.ADJOINT_TILE
        got = bc.predict_off_plan_tiles(_t(x), _t(y), (ny, nx))
        assert got == _global_tiles_reference(x, y, (ny, nx), tile, bc.PLAN_MAX_COLS)
        assert (got > 0) == (qrows == 1)
        assert bc.planned_route(*bc.query_grid(_t(x))) == (qrows > 1)


def test_query_grid():
    """K4's query grid: a 2-D tensor's own shape, the last axis by the rest
    for more axes, one row for 1-D."""
    from pyimcom_tpu_torch.ops import bilinear_cuda as bc

    assert bc.query_grid(torch.zeros(7)) == (1, 7)
    assert bc.query_grid(torch.zeros(4, 9)) == (4, 9)
    assert bc.query_grid(torch.zeros(2, 3, 5)) == (6, 5)


# --------------------------------------------------------------------------
# the problem: one sky through three dithered SCAs, with stripes
# --------------------------------------------------------------------------

def _arrays(seed, scale=0.1):
    """(images (3, SIZE, SIZE), stripes, rng): a smooth sky through three
    dithered WCSs plus seeded row stripes."""
    rng = np.random.default_rng(seed)
    stripes = [rng.normal(scale=scale, size=SIZE) for _ in range(3)]
    yy, xx = np.mgrid[0:SIZE, 0:SIZE].astype(float)
    imgs = []
    for k, (dx, dy) in enumerate(DITHERS):
        w = RefWCS(crpix=((SIZE - 1) / 2 + dx, (SIZE - 1) / 2 + dy), **WCS_ARGS)
        ra, dec = w.pix2world(xx.ravel(), yy.ravel())
        sky = (np.sin(ra * 2000) + np.cos(dec * 3000)).reshape(SIZE, SIZE)
        imgs.append(sky + stripes[k][:, None])
    return np.stack(imgs), stripes, rng


def _scas(mod, wcs_cls, imgs, gains=None):
    return [mod.Sca_img(img, wcs_cls(crpix=((SIZE - 1) / 2 + dx, (SIZE - 1) / 2 + dy),
                                     **WCS_ARGS),
                        g_eff=None if gains is None else gains[k], name=f"sca{k}")
            for k, (img, (dx, dy)) in enumerate(zip(imgs, DITHERS))]


def _port_problem(imgs, gains=None, **kw):
    return imdestripe.DestripeProblem(_scas(imdestripe, WCS, imgs, gains), NEIGHBORS,
                                      device="cpu", **kw)


def _ref_problem(imgs, gains=None, use_device=True, **kw):
    return ref.DestripeProblem(_scas(ref, RefWCS, imgs, gains), NEIGHBORS,
                               use_device=use_device, **kw)


def _case(name):
    """(images, gains, problem keywords) of one parity case."""
    imgs, _stripes, rng = _arrays(21)
    gains, kw = None, {}
    if name == "gain":
        gains = [rng.uniform(0.5, 2.0, (SIZE, SIZE)) for _ in range(3)]
    elif name == "amp_cols":
        kw = dict(amp_cols=SIZE // 2, col_boundary_const=5.0,
                  mask=[rng.random((SIZE, SIZE)) > 0.1 for _ in range(3)])
    elif name in ("absolute", "huber_loss"):
        kw = dict(cost_model=name, hub_thresh=0.05)
    return imgs, gains, kw


PARITY = ("uniform", "gain", "amp_cols", "absolute", "huber_loss")


@pytest.mark.parametrize("at", ["zero", "random"])
@pytest.mark.parametrize("name", PARITY)
def test_cost_and_gradient_match_jax_device_route(name, at):
    imgs, gains, kw = _case(name)
    port, jref = _port_problem(imgs, gains, **kw), _ref_problem(imgs, gains, **kw)
    p = np.zeros(port.offsets[-1])
    if at == "random":
        p = np.random.default_rng(31).normal(scale=0.01, size=p.size)
    cost, grad = port.cost_and_grad(p)
    np.testing.assert_allclose(cost, jref.cost(p), rtol=1e-12)
    np.testing.assert_allclose(port.cost(p), cost, rtol=1e-14)
    np.testing.assert_allclose(grad, jref.gradient(p), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(port.gradient(p), grad, rtol=0, atol=0)


def test_cost_and_gradient_match_jax_host_route():
    """Uniform gain: the JAX package's host route (per-target NumPy cost and
    hand-written adjoint) is exact too."""
    imgs, _gains, _kw = _case("uniform")
    port, host = _port_problem(imgs), _ref_problem(imgs, use_device=False)
    p = np.random.default_rng(32).normal(scale=0.01, size=port.offsets[-1])
    np.testing.assert_allclose(port.cost(p), host.cost(p), rtol=1e-12)
    np.testing.assert_allclose(port.gradient(p), host.gradient(p), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("name", ["gain", "amp_cols"])
def test_plain_route_matches_kernel_route(name):
    """DestripeCost's plain route (autograd through the plain gather, each
    pair recomputed in the backward) against its BilinearGather route."""
    imgs, gains, kw = _case(name)
    dc = _port_problem(imgs, gains, **kw).device_cost
    p = _t(np.random.default_rng(33).normal(scale=0.01, size=3 * dc.np_each))
    e0, g0 = dc.value_and_grad(p)
    e1, g1 = dc.value_and_grad(p, plain=True)
    np.testing.assert_allclose(float(e1), float(e0), rtol=1e-12)
    np.testing.assert_allclose(g1.numpy(), g0.numpy(), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("name", ["gain", "amp_cols"])
def test_cost_and_gradient_on_grid_maps_match_flat_maps_and_jax(name):
    """DestripeCost keeps each pair's positions and accumulator on the
    target's (ny, nx) pixel grid (the layout K4 tiles): built from maps given
    as grids (as DestripeProblem gives them) or flat, its cost and gradient
    are the same, bit for bit, and hold the JAX device route."""
    imgs, gains, kw = _case(name)
    port, jref = _port_problem(imgs, gains, **kw), _ref_problem(imgs, gains, **kw)
    grid = port.device_cost
    assert grid.xf.shape == (len(grid.pairs), SIZE, SIZE)
    mask = port.mask
    flat = DestripeCost(np.stack([s.image for s in port.scas]),
                        np.stack([s.g_eff for s in port.scas]),
                        None if mask is None else np.stack(mask), grid.pairs,
                        [m.reshape(-1).numpy() for m in grid.xf],
                        [m.reshape(-1).numpy() for m in grid.yf], amp_cols=port.amp_cols,
                        cost_model=port.cost_model, hub=port.hub,
                        col_boundary_const=port.col_boundary_const,
                        bmasks=[mask[i] if mask is not None else s.mask
                                for i, s in enumerate(port.scas)], device="cpu")
    p = np.random.default_rng(35).normal(scale=0.01, size=port.offsets[-1])
    cost, grad = grid.cost_and_grad(p)
    cost_flat, grad_flat = flat.cost_and_grad(p)
    assert cost == cost_flat and np.array_equal(grad, grad_flat)
    np.testing.assert_allclose(cost, jref.cost(p), rtol=1e-12)
    np.testing.assert_allclose(grad, jref.gradient(p), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("name", ["gain", "amp_cols", "huber_loss"])
def test_gradient_matches_finite_differences(name):
    imgs, gains, kw = _case(name)
    prob = _port_problem(imgs, gains, **kw)
    p = np.random.default_rng(34).normal(scale=0.01, size=prob.offsets[-1])
    g = prob.gradient(p)
    for idx in [3, 57, SIZE + 1, 222]:
        h = 1e-6
        dp = np.zeros_like(p)
        dp[idx] = h
        fd = (prob.cost(p + dp) - prob.cost(p - dp)) / (2 * h)
        assert abs(fd - g[idx]) < 1e-4 * max(1.0, abs(fd)), (idx, fd, g[idx])


def test_conjugate_gradient_matches_jax():
    imgs, _stripes, rng = _arrays(41, scale=0.2)
    gains = [rng.uniform(0.5, 2.0, (SIZE, SIZE)) for _ in range(3)]
    quiet = dict(maxiter=5, log=lambda *a: None)
    got, hist = imdestripe.conjugate_gradient(_port_problem(imgs, gains), **quiet)
    want, ref_hist = ref.conjugate_gradient(_ref_problem(imgs, gains), **quiet)
    assert len(hist) == len(ref_hist) == 5
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8 * np.abs(want).max())
    np.testing.assert_allclose([h["cost"] for h in hist], [h["cost"] for h in ref_hist],
                               rtol=1e-8)


@pytest.mark.parametrize("beta_model", ["FR", "PR", "HS", "DY"])
def test_stripe_recovery_all_beta_models(beta_model):
    imgs, _stripes, _rng = _arrays(7, scale=0.2)
    prob = _port_problem(imgs)
    params, _ = imdestripe.conjugate_gradient(prob, maxiter=25, beta_model=beta_model,
                                              log=lambda *a: None)
    assert prob.cost(params) < 1e-5 * prob.cost(np.zeros_like(params))


def test_huber_cost_general_line_search():
    imgs, _stripes, _rng = _arrays(8, scale=0.2)
    prob = _port_problem(imgs, cost_model="huber_loss", hub_thresh=0.5)
    params, _ = imdestripe.conjugate_gradient(prob, maxiter=10, log=lambda *a: None)
    assert prob.cost(params) < 0.05 * prob.cost(np.zeros_like(params))


def test_cg_restart_and_log(tmp_path):
    import csv

    imgs, _stripes, _rng = _arrays(6, scale=0.2)
    prob = _port_problem(imgs)
    rfile, logf = str(tmp_path / "cg_restart.pkl"), str(tmp_path / "cg_log.csv")
    quiet = dict(restart_file=rfile, log=lambda *a: None, csv_file=logf)
    p1, _h1 = imdestripe.conjugate_gradient(prob, maxiter=3, **quiet)
    p2, h2 = imdestripe.conjugate_gradient(prob, maxiter=6, **quiet)
    assert h2[0]["iteration"] == 3                      # resumed, not restarted
    assert prob.cost(p2) <= prob.cost(p1) + 1e-9
    with open(logf) as f:
        rows = list(csv.reader(f))
    assert rows[0] == imdestripe._CSV_HEADER == ref._CSV_HEADER
    assert [int(r[0]) for r in rows[1:]] == [1, 2, 3, 4, 5, 6]
    assert float(rows[-1][6]) <= float(rows[1][6])


def test_interpolation_wrappers_match_jax():
    imgs, _stripes, rng = _arrays(9)
    gains = [rng.uniform(0.5, 2.0, (SIZE, SIZE)) for _ in range(3)]
    port_scas, ref_scas = _scas(imdestripe, WCS, imgs, gains), _scas(ref, RefWCS, imgs, gains)
    got, want = np.zeros((SIZE, SIZE)), np.zeros((SIZE, SIZE))
    imdestripe.interpolate_image_bilinear(port_scas[1], port_scas[0], got, device="cpu")
    ref.interpolate_image_bilinear(ref_scas[1], ref_scas[0], want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    mask = (rng.random((SIZE, SIZE)) > 0.5).astype(float)
    imdestripe.interpolate_image_bilinear(port_scas[1], port_scas[0], got, mask=mask,
                                          device="cpu")
    ref.interpolate_image_bilinear(ref_scas[1], ref_scas[0], want, mask=mask)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    imdestripe.transpose_interpolate(imgs[0], port_scas[0].w, port_scas[1], got, device="cpu")
    ref.transpose_interpolate(imgs[0], ref_scas[0].w, ref_scas[1], want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_main_matches_jax_main(tmp_path):
    """main on three 100^2 FITS SCAs (object mask and WCS gain on, 5 CG
    steps): the port's ds_*.fits triplets against the JAX main's."""
    from survey_fixture_torch import CONFIG_TEMPLATE

    imgs, _stripes, _rng = _arrays(10, scale=0.05)
    (tmp_path / "in").mkdir()
    for k, (img, (dx, dy)) in enumerate(zip(imgs, DITHERS)):
        w = WCS(crpix=((SIZE - 1) / 2 + dx, (SIZE - 1) / 2 + dy), **WCS_ARGS)
        fits_write(tmp_path / "in" / f"sim_L2_F184_{k}_1.fits",
                   HDUList([ImageHDU((0.1 * img).astype(np.float32),
                                     header=Header(w.to_header()))]))
    outs = {}
    for name, mod, cfg_cls in (("port", imdestripe, Config), ("ref", ref, RefConfig)):
        d = {k: (v.replace("$DIR", str(tmp_path)) if isinstance(v, str) else v)
             for k, v in CONFIG_TEMPLATE.items()}
        d["DSOUT"] = [str(tmp_path / name), "ds"]
        d["DSOBSFILE"] = str(tmp_path / "in" / "sim_L2_*[0-9].fits")
        cfgfile = tmp_path / f"cfg_{name}.json"
        cfgfile.write_text(json.dumps(d))
        kw = dict(device="cpu") if name == "port" else {}
        outs[name] = mod.main(cfg_cls(str(cfgfile)), maxiter=5, **kw)
    (p_port, h_port), (p_ref, _h_ref) = outs["port"], outs["ref"]
    assert len(h_port) == 5
    np.testing.assert_allclose(p_port, p_ref, rtol=0, atol=1e-8 * np.abs(p_ref).max())
    for k in range(3):
        got = fits_read(tmp_path / "port" / f"ds_F184_{k}_1.fits")
        want = fits_read(tmp_path / "ref" / f"ds_F184_{k}_1.fits")
        assert [h.name for h in got][1:] == ["ORIG", "PARAMS"]
        for g, w in zip(got, want):
            a, b = np.asarray(g.data, np.float64), np.asarray(w.data, np.float64)
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * np.abs(b).max())
        assert dict(got[0].header) == dict(want[0].header)
    assert os.path.exists(tmp_path / "port" / "cg_log.csv")
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "ovmat.npy"),
                                  np.load(tmp_path / "ref" / "ovmat.npy"))


def test_main_asks_for_the_card_first(tmp_path):
    """main runs on the card unless asked for the CPU; without a card it
    raises before it reads any input (the DSOBSFILE glob here matches
    nothing, which would raise another error)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: main would run on it")
    from survey_fixture_torch import CONFIG_TEMPLATE

    d = {k: (v.replace("$DIR", str(tmp_path)) if isinstance(v, str) else v)
         for k, v in CONFIG_TEMPLATE.items()}
    d.update(DSOUT=[str(tmp_path / "ds"), "ds"], DSOBSFILE=str(tmp_path / "none_*.fits"))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        imdestripe.main(Config(d))
    with pytest.raises(RuntimeError, match="at least two"):
        imdestripe.main(Config(d), device="cpu")
