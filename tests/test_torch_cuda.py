"""The CUDA kernels K1 and K2, the destriping pair K3 and K4 (and the
destripe cost that runs them), against their plain versions, and the probe
kernel, on the card.

These tests need a CUDA GPU (and the CUDA toolkit, to build the kernels);
they skip without one.  On a machine with the card, run them without the
repository's JAX conftests:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py

The kernels compute in f64 with another summation order (and fused
multiply-adds) than the plain versions; they agree to 1e-12 of scale.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pyimcom_tpu_torch import probe
from pyimcom_tpu_torch.ops import bilinear, bilinear_cuda, interp, interp_cuda
from pyimcom_tpu_torch.ops.destripe_device import DestripeCost
from k2_layout_torch import b_layout_bytes

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu
TOL = 1e-12


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU or interpret mode")
    return torch.device("cuda", 0)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


K1_SETS = ("rotated", "star", "random")


def k1_query_set(kind, R, n, ns, seed):
    """Seeded (images (R, ns, ns), x, y (R, n * n)) in the shapes of K1's
    callers: 'rotated' -- an n x n output lattice about one sample apart,
    rotated and sheared a little (a near-affine WCS map), as
    psfgrp.sample_psf_rotated_batch makes it, its centre moved off the
    image's so that part of it falls off; 'star' -- an n x n pixel patch
    around a star, spaced 6 oversampled samples apart, as
    layer._draw_patches makes it (most of it off the image); 'random' --
    uniform points over the image and 5 samples past its edges."""
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(R, ns, ns))
    if kind == "random":
        return (images, rng.uniform(-5, ns + 5, (R, n * n)),
                rng.uniform(-5, ns + 5, (R, n * n)))
    ax = np.arange(n) - (n - 1) / 2.0
    if kind == "rotated":
        ang = rng.uniform(0, 2 * np.pi, R)
        jac = np.stack([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
        jac = jac * rng.uniform(0.99, 1.01, (2, 2, R))          # the WCS's distortion
        ctr = (ns - 1) / 2.0 + rng.uniform(-0.3, 0.3, (2, R)) * ns
        yo, xo = np.meshgrid(ax, ax, indexing="ij")
        x = jac[0, 0][:, None] * xo.ravel() + jac[0, 1][:, None] * yo.ravel() + ctr[0][:, None]
        y = jac[1, 0][:, None] * xo.ravel() + jac[1, 1][:, None] * yo.ravel() + ctr[1][:, None]
        return images, x, y
    ov, p = 6, 6
    ctr = (ns - 2 * p - 1) / 2.0
    xs, ys = rng.uniform(100, 200, R), rng.uniform(100, 200, R)
    gx = np.floor(xs).astype(int)[:, None, None] - n // 2 + np.arange(n)[None, None, :]
    gy = np.floor(ys).astype(int)[:, None, None] - n // 2 + np.arange(n)[None, :, None]
    x = ov * (gx - xs[:, None, None]) + ctr + p
    y = ov * (gy - ys[:, None, None]) + ctr + p
    x, y = np.broadcast_arrays(x, y)
    return images, x.reshape(R, -1), y.reshape(R, -1)


def _k1_case(cuda, images, x, y, **kw):
    """K1 (one launch, counted) and its plain version on the card; returns
    (result, plain result)."""
    images, x, y = (torch.as_tensor(np.ascontiguousarray(a), device=cuda)
                    for a in (images, x, y))
    interp_cuda.reset_launch_counts()
    got = interp_cuda.interp_dense(images, x, y, **kw)
    assert interp_cuda.launches["interp_d5512_dense"] == 1
    want = interp_cuda.interp_dense_plain(images, x, y)
    assert interp_cuda.launches["interp_d5512_dense"] == 1
    return got, want


@pytest.mark.parametrize("lattice", [False, True], ids=["runs", "lattice"])
@pytest.mark.parametrize("kind", K1_SETS)
def test_k1_matches_plain_on_main_path_sets(cuda, kind, lattice):
    """The callers' lattices and random points, in runs of 32 consecutive
    queries and (where the caller says so) of 8 x 4 lattice points."""
    images, x, y = k1_query_set(kind, 8, 40, 140, seed=K1_SETS.index(kind))
    got, want = _k1_case(cuda, images, x, y, lattice_row=40 * lattice)
    assert int((want != 0).sum()) > 0
    assert _rel(got, want) < TOL
    assert torch.equal(got == 0, want == 0)


def test_k1_odd_rows_read_sample_by_sample(cuda):
    """An image with an odd row length (no 16-byte pairs) and one whose
    stack starts off 16 bytes: both take the sample-by-sample reads."""
    images, x, y = k1_query_set("rotated", 3, 40, 141, seed=12)
    got, want = _k1_case(cuda, images, x, y, lattice_row=40)
    assert _rel(got, want) < TOL
    images, x, y = k1_query_set("rotated", 3, 40, 140, seed=13)
    stack = torch.as_tensor(np.concatenate([[0.0], images.ravel()]), device=cuda)
    shifted = stack[1:].view(images.shape)          # 8 bytes past a 16-byte boundary
    xq, yq = torch.as_tensor(x, device=cuda), torch.as_tensor(y, device=cuda)
    interp_cuda.reset_launch_counts()
    got = interp_cuda.interp_dense(shifted, xq, yq, lattice_row=40)
    assert interp_cuda.launches["interp_d5512_dense"] == 1
    assert _rel(got, interp_cuda.interp_dense_plain(shifted, xq, yq)) < TOL


@pytest.mark.parametrize("lattice", [False, True], ids=["runs", "lattice"])
@pytest.mark.parametrize("R, n", [(1, 70), (3, 33), (2, 1)],
                         ids=["R1", "Nq-ragged", "Nq1"])
def test_k1_edges(cuda, R, n, lattice):
    """One image; Nq = 1089 and 1, multiples of neither T nor a warp's run;
    lattice rows (33, 1) that are not multiples of a lattice run's 8."""
    images, x, y = k1_query_set("rotated", R, n, 90, seed=7)
    x[:, 0] = 45.25                                # one query surely on the grid
    got, want = _k1_case(cuda, images, x, y, lattice_row=n * lattice)
    assert _rel(got, want) < TOL
    assert torch.equal(got == 0, want == 0)


def test_k1_no_queries_launches_nothing(cuda):
    images = torch.zeros((2, 30, 30), dtype=torch.float64, device=cuda)
    q = torch.zeros((2, 0), dtype=torch.float64, device=cuda)
    interp_cuda.reset_launch_counts()
    assert interp_cuda.interp_dense(images, q, q).shape == (2, 0)
    assert interp_cuda.launches["interp_d5512_dense"] == 0


def test_k1_nan_queries_give_zero(cuda):
    images, x, y = k1_query_set("rotated", 2, 40, 80, seed=3)
    x[0, ::3] = np.nan
    y[1, 1::5] = np.nan
    x[1, 2] = np.inf
    got, want = _k1_case(cuda, images, x, y)
    assert torch.all(got[0, ::3] == 0) and torch.all(got[1, 1::5] == 0) and got[1, 2] == 0
    assert _rel(got, want) < TOL
    assert torch.equal(got == 0, want == 0)


def test_k1_matches_plain_and_counts_launches(cuda):
    rng = np.random.default_rng(0)
    R, Nq, ns = 5, 3000, 91                    # no (8, 128) alignment needed
    images = torch.as_tensor(rng.normal(size=(R, ns, ns)), device=cuda)
    x = torch.as_tensor(rng.uniform(-4, ns + 4, (R, Nq)), device=cuda)
    y = torch.as_tensor(rng.uniform(-4, ns + 4, (R, Nq)), device=cuda)
    interp_cuda.reset_launch_counts()
    got = interp.interp2d_dense(images, x, y)
    assert interp_cuda.launches["interp_d5512_dense"] == 1
    want = interp_cuda.interp_dense_plain(images, x, y)
    assert interp_cuda.launches["interp_d5512_dense"] == 1
    assert _rel(got, want) < TOL
    assert torch.equal(got == 0, want == 0)


def _k2_case(cuda, mode, spread):
    """Seeded K2 rows with odd offsets and a padded row: pool rows, or B rows
    on a 6 x 6 output lattice at table entry 400.  Returns (dst size, the
    wrapper's arguments after dst, the tiles, nval)."""
    rng = np.random.default_rng(1 + mode)
    K, ns, L, rows, nmax = 4, 231, 500, 6, 1024
    n2f, n_pad = 6, 200
    m = n2f * n2f
    combined = torch.as_tensor(rng.normal(size=(K, ns, ns)), device=cuda)
    xt_np, yt_np = rng.uniform(0, spread, L), rng.uniform(0, spread, L)
    p = np.arange(m)
    xt_np[400:400 + m], yt_np[400:400 + m] = 8.0 + p % n2f, 9.0 + p // n2f
    xt, yt = torch.as_tensor(xt_np, device=cuda), torch.as_tensor(yt_np, device=cuda)
    ks = rng.integers(0, K, rows)
    w2 = np.full(rows, m) if mode else rng.integers(5, 60, rows)
    nval = rng.integers(nmax // 2, nmax + 1, rows)
    nval[-1] = 0                                # a padded row
    off = rng.integers(0, 50, rows)
    i2 = np.full(rows, 400) if mode else rng.integers(0, 100, rows)
    imeta = np.stack([rng.integers(0, 100, rows), i2, w2, off, nval], 1)
    if mode == 0:
        base = np.arange(rows) * 4 * nmax
        dmeta = np.stack([base, w2, w2 + 3, off, nval], 1)
        size = rows * 4 * nmax
    else:
        dmeta = np.stack([np.zeros(rows, int), np.arange(rows) * 30, off, nval], 1)
        size = m * n_pad

    def put(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=cuda)

    tiles = interp_cuda.sweep_tiles(imeta, mode, xt_np, yt_np, n2f)
    args = (combined, xt, yt, put(ks), put(imeta), put(dmeta), put(tiles),
            1.0 if spread > 100 else 1.7, 115.0, mode, n_pad, n2f)
    return size, args, tiles, nval


@pytest.mark.parametrize("mode, spread", [(0, 20.0), (0, 120.0), (1, 20.0)],
                         ids=["pool", "pool-l2", "B"])
def test_k2_matches_plain(cuda, mode, spread):
    """K2 against its plain version: pool tiles staged in shared memory, pool
    tiles whose window outgrows it (coordinates spread over 120 pixels:
    such tiles read from L2 and are counted), and B rows on an output
    lattice, with odd offsets and a padded row."""
    size, args, tiles, nval = _k2_case(cuda, mode, spread)
    interp_cuda.reset_launch_counts()
    interp_cuda.reset_l2_tiles()
    got = interp_cuda.sweep_scatter(
        torch.zeros(size, dtype=torch.float64, device=cuda), *args)
    assert interp_cuda.launches[interp_cuda.sweep_kernel("D5512", mode)] == 1
    l2 = interp_cuda.l2_tiles(cuda)
    want = interp_cuda.sweep_scatter_plain(
        torch.zeros(size, dtype=torch.float64, device=cuda), *args)
    assert interp_cuda.launches[interp_cuda.sweep_kernel("D5512", mode)] == 1
    assert int((want != 0).sum()) > int(nval.sum()) // 2
    assert _rel(got, want) < TOL
    assert (0 < l2 <= len(tiles)) if spread > 100 else (l2 == 0), (l2, len(tiles))


def test_k2_raises_on_what_it_cannot_take(cuda):
    """No fallback: a wrong dtype, a non-contiguous stack and a CPU tensor
    raise on the card (a B plan off the lattice raises where its tiles are
    made, tests/test_torch_assemble.py); a good plan after a bad one runs."""
    size, args, _tiles, _nval = _k2_case(cuda, 1, 20.0)
    combined, xt, yt, ks, imeta, dmeta, tiles, *rest = args

    def sweep(**over):
        a = dict(combined=combined, xt=xt, yt=yt, imeta=imeta)
        a.update(over)
        return interp_cuda.sweep_scatter(
            torch.zeros(size, dtype=torch.float64, device=cuda), a["combined"], a["xt"],
            a["yt"], ks, a["imeta"], dmeta, tiles, *rest)

    with pytest.raises(ValueError, match="CUDA"):
        sweep(xt=xt.cpu())
    with pytest.raises(TypeError):
        sweep(combined=combined.float())
    with pytest.raises(ValueError, match="contiguous"):
        sweep(combined=combined.transpose(1, 2))
    assert float(sweep().abs().max()) > 0


def test_wrappers_reject_bad_inputs_on_the_card(cuda):
    images = torch.zeros((2, 20, 20), dtype=torch.float32, device=cuda)
    q = torch.zeros((2, 8), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        interp_cuda.interp_dense(images, q, q)
    with pytest.raises(ValueError):
        interp_cuda.interp_dense(images.double(), q.T.contiguous(), q.T.contiguous())
    with pytest.raises(ValueError, match="lattice_row"):
        interp_cuda.interp_dense(images.double(), q, q, lattice_row=3)


def test_probe_kernel_builds_and_adds_one(cuda):
    """csrc/probe.cu builds for sm_90a and its kernel gives exactly x + 1."""
    probe.reset_launch_counts()
    verdict = probe.run()
    assert verdict["ok"] and verdict["build_s"] > 0, verdict
    assert probe.launches["probe_add_one"] == 1
    x = torch.as_tensor(np.random.default_rng(5).normal(size=3001),
                        dtype=torch.float32, device=cuda)
    assert torch.equal(probe.probe_add_one(x), probe.probe_add_one_plain(x))
    with pytest.raises(TypeError):
        probe.probe_add_one(x.double())


# --------------------------------------------------------------------------
# K3 / K4: the destriping bilinear pair
# --------------------------------------------------------------------------

def _bil_case(cuda, seed, ny=300, nx=257, n=60_000):
    """Seeded image, gain and values, and n points: a rotated, shifted copy
    of the grid (the shape of a destripe pair map: neighbouring queries on
    neighbouring pixels), part of it off the grid, with NaN and infinite
    positions among them."""
    rng = np.random.default_rng(seed)
    th = 0.1
    q = np.arange(n)
    xx, yy = (q % nx).astype(float), (q // nx).astype(float)
    xf = np.cos(th) * xx - np.sin(th) * yy + 12.3
    yf = np.sin(th) * xx + np.cos(th) * yy - 17.6
    xf[::97], yf[5::89], xf[7::101] = np.nan, np.nan, np.inf
    put = lambda a: torch.as_tensor(a, device=cuda)          # noqa: E731
    return (put(rng.normal(size=(ny, nx))), put(rng.uniform(0.5, 2.0, (ny, nx))),
            put(xf), put(yf), put(rng.normal(size=n)))


@pytest.mark.parametrize("accumulate", [False, True], ids=["write", "accumulate"])
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_k3_matches_plain(cuda, weighted, accumulate):
    img, gain, x, y, v = _bil_case(cuda, 20)
    g = gain if weighted else None
    bilinear_cuda.reset_launch_counts()
    got = bilinear_cuda.bilinear_gather(img, x, y, g, out=v.clone() if accumulate else None)
    assert bilinear_cuda.launches["bilinear_gather"] == 1
    want = bilinear.bilinear_gather_plain(img, x, y, g) + (v if accumulate else 0.0)
    assert bilinear_cuda.launches["bilinear_gather"] == 1
    assert _rel(got, want) < TOL
    off = ~bilinear.in_bounds(x, y, img.shape)
    assert int(off.sum()) > 1000 and int((~off).sum()) > 20_000
    if not accumulate:
        assert torch.all(got[off] == 0)


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_k4_matches_plain(cuda, weighted):
    img, gain, x, y, v = _bil_case(cuda, 21)
    g = gain if weighted else None
    bilinear_cuda.reset_launch_counts()
    got = bilinear_cuda.bilinear_scatter_adjoint(v, x, y, img.shape, g)
    assert bilinear_cuda.launches["bilinear_scatter_adjoint"] == 1
    want = bilinear.bilinear_scatter_adjoint_plain(v, x, y, img.shape, g)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_k3_k4_adjoint_identity_on_the_card(cuda, weighted):
    img, gain, x, y, v = _bil_case(cuda, 22)
    g = gain if weighted else None
    lhs = float(torch.dot(bilinear_cuda.bilinear_gather(img, x, y, g), v))
    rhs = float(torch.sum(img * bilinear_cuda.bilinear_scatter_adjoint(v, x, y, img.shape, g)))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


def test_k3_k4_nan_and_off_grid_give_zero(cuda):
    """Positions off the grid (the last row and column included), NaN and
    infinite: K3 gives 0 and K4 adds nothing."""
    img, gain, _x, _y, _v = _bil_case(cuda, 23)
    ny, nx = img.shape
    x = torch.tensor([-0.5, nx - 1.0, 3.0, float("nan"), 5.0, float("inf"), -float("inf"),
                      float(nx) + 4], dtype=torch.float64, device=cuda)
    y = torch.tensor([3.0, 3.0, ny - 1.0, 4.0, float("nan"), 6.0, 7.0, 2.0],
                     dtype=torch.float64, device=cuda)
    v = torch.ones_like(x)
    for g in (None, gain):
        assert torch.all(bilinear_cuda.bilinear_gather(img, x, y, g) == 0)
        assert torch.all(bilinear_cuda.bilinear_scatter_adjoint(v, x, y, img.shape, g) == 0)


def test_k3_k4_no_queries_launch_nothing(cuda):
    img = torch.zeros((30, 30), dtype=torch.float64, device=cuda)
    q = torch.zeros(0, dtype=torch.float64, device=cuda)
    bilinear_cuda.reset_launch_counts()
    assert bilinear_cuda.bilinear_gather(img, q, q).shape == (0,)
    assert bilinear_cuda.bilinear_scatter_adjoint(q, q, q, img.shape).shape == (30, 30)
    assert not any(bilinear_cuda.launches.values()), bilinear_cuda.launches


def test_bilinear_wrappers_raise_on_bad_inputs(cuda):
    img, gain, x, y, v = _bil_case(cuda, 24, n=1000)
    with pytest.raises(TypeError):
        bilinear_cuda.bilinear_gather(img.float(), x, y)
    with pytest.raises(ValueError, match="CUDA"):
        bilinear_cuda.bilinear_gather(img, x.cpu(), y)
    with pytest.raises(ValueError, match="contiguous"):
        bilinear_cuda.bilinear_gather(img.T, x, y)
    with pytest.raises(ValueError, match="one shape"):
        bilinear_cuda.bilinear_gather(img, x, y[:-1])
    with pytest.raises(ValueError, match="g_eff"):
        bilinear_cuda.bilinear_gather(img, x, y, gain[:-1])
    with pytest.raises(ValueError, match="out"):
        bilinear_cuda.bilinear_gather(img, x, y, out=v[:-1])
    with pytest.raises(ValueError, match="values"):
        bilinear_cuda.bilinear_scatter_adjoint(v[:-1], x, y, img.shape)
    assert float(bilinear_cuda.bilinear_gather(img, x, y).abs().max()) > 0


def test_bilinear_gather_backward_launches_k4(cuda):
    img, gain, x, y, v = _bil_case(cuda, 25)
    image = img.clone().requires_grad_(True)
    bilinear_cuda.reset_launch_counts()
    out = bilinear.BilinearGather.apply(image, x, y, gain, torch.zeros_like(v))
    (grad,) = torch.autograd.grad(out, image, v)
    assert bilinear_cuda.launches == {"bilinear_gather": 1, "bilinear_scatter_adjoint": 1,
                                      "bilinear_gather.f32": 0,
                                      "bilinear_scatter_adjoint.f32": 0,
                                      "bilinear_adjoint_plan": 0,
                                      "bilinear_adjoint_plan.f32": 0}
    assert _rel(grad, bilinear.bilinear_scatter_adjoint_plain(v, x, y, img.shape, gain)) < TOL


def _grid_case(cuda, seed, roll, qny=150, qnx=173, ny=170, nx=190, scale=1.0):
    """Seeded image, gain and values on a (qny, qnx) query grid -- ragged
    against K4's 32 x 32 tiles -- rolled by `roll` degrees and scaled by
    `scale` (a destripe pair map), shifted so that part of it falls off the
    image; with NaN and +-inf positions, and queries exactly on the last row
    and column (off the grid) beside ones that read them (in bounds)."""
    rng = np.random.default_rng(seed)
    th = np.deg2rad(roll)
    yy, xx = np.mgrid[0:qny, 0:qnx].astype(float)
    u, w = xx - qnx / 2, yy - qny / 2
    xf = scale * (np.cos(th) * u - np.sin(th) * w) + nx / 2 + 22.3
    yf = scale * (np.sin(th) * u + np.cos(th) * w) + ny / 2 + 12.4
    xf[3, ::7], yf[::11, 5] = np.nan, np.nan
    xf[40, 2::13], yf[60, 3::17] = np.inf, -np.inf
    for pos, last in ((xf, nx - 1.0), (yf, ny - 1.0)):
        near = np.abs(pos - last) < 0.5
        near[1::3] = False                  # these read the last taps
        pos[near] = last
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=cuda)   # noqa: E731
    return (put(rng.normal(size=(ny, nx))), put(rng.uniform(0.5, 2.0, (ny, nx))),
            put(xf), put(yf), put(rng.normal(size=(qny, qnx))))


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("roll", [0, 15, 45, 90])
def test_k4_matches_plain_on_rotated_grids(cuda, roll, weighted):
    """K4 on a 2-D query grid (the destripe pair's layout), over its plan,
    in both position forms, fresh and added into an output: one planned
    launch each, nothing off the plan, held to the plain version; two
    launches give the same bits."""
    img, gain, x64, y64, v = _grid_case(cuda, 40 + roll, roll)
    g = gain if weighted else None
    inb = bilinear.in_bounds(x64, y64, img.shape)
    assert int(inb.sum()) > 10_000 and int((~inb).sum()) > 1000
    assert bool(torch.any(x64 == img.shape[1] - 1)) and bool(torch.any(y64 == img.shape[0] - 1))
    assert int(torch.floor(x64[inb]).max()) == img.shape[1] - 2    # the last column's taps
    assert int(torch.floor(y64[inb]).max()) == img.shape[0] - 2    # the last row's
    base = torch.randn(img.shape, dtype=torch.float64, device=cuda)
    for x, y in ((x64, y64), (x64.float(), y64.float())):
        plan = bilinear_cuda.build_adjoint_plan(x, y, img.shape)
        want = bilinear.bilinear_scatter_adjoint_plain(v, x, y, img.shape, g)
        bilinear_cuda.reset_launch_counts()
        bilinear_cuda.reset_off_plan_tiles()
        got = bilinear_cuda.bilinear_scatter_adjoint(v, x, y, img.shape, g, plan=plan)
        into = bilinear_cuda.bilinear_scatter_adjoint(v, x, y, img.shape, g, plan=plan,
                                                      out=base.clone())
        again = bilinear_cuda.bilinear_scatter_adjoint(v, x, y, img.shape, g, plan=plan)
        key = "bilinear_scatter_adjoint" + (".f32" if x.dtype == torch.float32 else "")
        assert bilinear_cuda.launches[key] == 3
        assert bilinear_cuda.adjoint_routes == {"planned": 3, "stream": 0}
        assert bilinear_cuda.off_plan_tiles(cuda) == 0
        assert bilinear_cuda.predict_off_plan_tiles(x, y, img.shape) == 0
        assert _rel(got, want) < TOL
        assert _rel(into, base + want) < TOL
        assert torch.equal(got, again)


@pytest.mark.parametrize("roll", [0, 15, 45, 90])
def test_k4_plan_kernel_matches_plain(cuda, roll):
    """The plan kernel (one pass over the positions, counted as one launch)
    gives the plain builder's plan word for word once checked, in both
    position forms, on a ragged rolled grid with NaN, infinite and off-grid
    positions, on a map scaled by 0.3 (many bands a tile), on a grid with no
    query in bounds and on a grid wider than a warp's 256 queries."""
    img, _gain, x64, y64, _v = _grid_case(cuda, 60 + roll, roll)
    _img, _gain, xs, ys, _v = _grid_case(cuda, 61, roll, ny=45, nx=40, scale=0.3)
    _img, _gain, xw, yw, _v = _grid_case(cuda, 62, roll, qny=80, qnx=700, ny=300, nx=520)
    cases = [(x64, y64, img.shape), (xs, ys, (45, 40)), (x64 + 1e4, y64, img.shape),
             (xw, yw, (300, 520))]
    for x, y, shape in cases:
        for xx, yy in ((x, y), (x.float(), y.float())):
            key = "bilinear_adjoint_plan" + (".f32" if xx.dtype == torch.float32 else "")
            bilinear_cuda.reset_launch_counts()
            got = bilinear_cuda.build_adjoint_plan(xx, yy, shape)
            want = bilinear_cuda.build_adjoint_plan_plain(xx, yy, shape)
            assert bilinear_cuda.launches[key] == 1
            got.check()
            for name in ("rows", "ptr", "spans"):
                assert torch.equal(getattr(got, name), getattr(want, name)), (roll, name)
            assert (got.pairs, got.window, got.bands, got.shape, got.grid) == (
                want.pairs, want.window, want.bands, want.shape, want.grid)


def test_k4_plan_builds_without_host_sync(cuda):
    """Building a plan on the card, in both position forms, waits for
    nothing on the host: it passes under torch's sync debug mode "error"
    (a read-back, .item() or .tolist(), would raise), and the plan is then
    the plain builder's."""
    img, _gain, x, y, _v = _grid_case(cuda, 63, 30)
    for xx, yy in ((x, y), (x.float(), y.float())):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = bilinear_cuda.build_adjoint_plan(xx, yy, img.shape)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want = bilinear_cuda.build_adjoint_plan_plain(xx, yy, img.shape)
        got.check()
        for name in ("rows", "ptr", "spans"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("pos", ["f64", "f32"])
def test_k4_shrunk_map_takes_the_off_plan_body(cuda, pos):
    """A map shrunk 0.1x spreads a tile's queries over more query rows than
    the plan kernel's ring: its plan (the kernel's, the plain builder's
    word for word) counts those tiles as overflowed, and K4 without a plan
    and over that plan takes the off-plan body, one stream launch each (the
    plan built in the call: one plan kernel launch), its tiles off the plan
    as predicted, within TOL of the plain version, fresh and into an
    output, with and without a gain."""
    img, gain, x, y, v = _grid_case(cuda, 64, 30, qny=400, qnx=60, ny=64, nx=64, scale=0.1)
    if pos == "f32":
        x, y = x.float(), y.float()
    plan = bilinear_cuda.build_adjoint_plan(x, y, img.shape)
    want_plan = bilinear_cuda.build_adjoint_plan_plain(x, y, img.shape)
    assert bilinear_cuda.plan_route(plan) == "stream" and plan.over == want_plan.over > 0
    for name in ("rows", "ptr", "spans"):
        assert torch.equal(getattr(plan, name), getattr(want_plan, name)), name
    n_off = bilinear_cuda.predict_off_plan_tiles(x, y, img.shape)
    assert n_off > 0
    suffix = ".f32" if pos == "f32" else ""
    base = torch.randn(img.shape, dtype=torch.float64, device=cuda)
    for g in (None, gain):
        want = bilinear.bilinear_scatter_adjoint_plain(v, x, y, img.shape, g)
        bilinear_cuda.reset_launch_counts()
        bilinear_cuda.reset_off_plan_tiles()
        got = bilinear_cuda.bilinear_scatter_adjoint(v, x, y, img.shape, g)
        into = bilinear_cuda.bilinear_scatter_adjoint(v, x, y, img.shape, g, plan=plan,
                                                      out=base.clone())
        assert bilinear_cuda.adjoint_routes == {"planned": 0, "stream": 2}
        assert bilinear_cuda.launches["bilinear_scatter_adjoint" + suffix] == 2
        assert bilinear_cuda.launches["bilinear_adjoint_plan" + suffix] == 1
        assert bilinear_cuda.off_plan_tiles(cuda) == 2 * n_off
        assert _rel(got, want) < TOL
        assert _rel(into, base + want) < TOL


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_k4_global_route_when_the_box_outgrows_shared_memory(cuda, weighted):
    """A grid scaled by 2.5, whose tiles outgrew the shared-memory box of
    the tiled body (its global route), takes the planned route whole: nothing
    off the plan, as predict_off_plan_tiles says, and the plain version's
    sums; so does the 15-degree pair grid, through a plan built in the
    call."""
    img, gain, x, y, v = _grid_case(cuda, 50, 30, ny=400, nx=420, scale=2.5)
    g = gain if weighted else None
    want = bilinear.bilinear_scatter_adjoint_plain(v, x, y, img.shape, g)
    bilinear_cuda.reset_launch_counts()
    bilinear_cuda.reset_off_plan_tiles()
    got = bilinear_cuda.bilinear_scatter_adjoint(v, x, y, img.shape, g)
    assert bilinear_cuda.off_plan_tiles(cuda) == 0
    assert bilinear_cuda.predict_off_plan_tiles(x, y, img.shape) == 0
    assert bilinear_cuda.adjoint_routes == {"planned": 1, "stream": 0}
    assert _rel(got, want) < TOL
    img, gain, x, y, v = _grid_case(cuda, 51, 15)
    bilinear_cuda.reset_off_plan_tiles()
    bilinear_cuda.bilinear_scatter_adjoint(v, x, y, img.shape, gain if weighted else None)
    assert bilinear_cuda.off_plan_tiles(cuda) == 0


@pytest.mark.parametrize("pos", ["f64", "f32"])
def test_k4_window_larger_than_staging(cuda, pos):
    """A map at a scale of 0.3 puts ~12000 queries and up to 39 bands in a
    tile's window, nine chunks or more of the kernel's staging buffer and three
    band groups: the planned kernel streams them and keeps ownership, equal
    to the plain version and to itself bit for bit."""
    img, gain, x, y, v = _grid_case(cuda, 54, 45, qny=600, qnx=580, ny=200, nx=190,
                                    scale=0.3)
    if pos == "f32":
        x, y = x.float(), y.float()
    plan = bilinear_cuda.build_adjoint_plan(x, y, img.shape)
    assert int((plan.ptr[1:] - plan.ptr[:-1]).max()) > 16 and plan.window > 8 * 1280 * 20
    want = bilinear.bilinear_scatter_adjoint_plain(v, x, y, img.shape, gain)
    got = bilinear_cuda.bilinear_scatter_adjoint(v, x, y, img.shape, gain, plan=plan)
    assert _rel(got, want) < TOL
    assert torch.equal(got, bilinear_cuda.bilinear_scatter_adjoint(v, x, y, img.shape, gain,
                                                                   plan=plan))


def test_k4_plan_checks(cuda):
    """A plan of other positions' grid or output raises, as does a plan
    given for a 1-D stream."""
    img, gain, x, y, v = _grid_case(cuda, 55, 15)
    plan = bilinear_cuda.build_adjoint_plan(x, y, img.shape)
    with pytest.raises(ValueError, match="plan"):
        bilinear_cuda.bilinear_scatter_adjoint(v[:-1], x[:-1], y[:-1], img.shape, plan=plan)
    with pytest.raises(ValueError, match="plan"):
        bilinear_cuda.bilinear_scatter_adjoint(v, x, y, (img.shape[0] + 1, img.shape[1]),
                                               plan=plan)
    with pytest.raises(ValueError, match="takes no plan"):
        bilinear_cuda.bilinear_scatter_adjoint(v.reshape(-1), x.reshape(-1), y.reshape(-1),
                                               img.shape, plan=plan)


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_k3_k4_adjoint_identity_on_a_grid(cuda, weighted):
    img, gain, x, y, v = _grid_case(cuda, 52, 30)
    g = gain if weighted else None
    lhs = float(torch.sum(bilinear_cuda.bilinear_gather(img, x, y, g) * v))
    rhs = float(torch.sum(img * bilinear_cuda.bilinear_scatter_adjoint(v, x, y, img.shape, g)))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


def test_k4_one_row_stream_counts_its_global_tiles(cuda):
    """A 1-D stream is one row of queries, tiled 1 x 1024, with no plan: it
    takes the off-plan body, one launch on that route, and counts each of
    its tiles holding a query in bounds, as predicted."""
    img, gain, x, y, v = _bil_case(cuda, 53)
    bilinear_cuda.reset_launch_counts()
    bilinear_cuda.reset_off_plan_tiles()
    got = bilinear_cuda.bilinear_scatter_adjoint(v, x, y, img.shape, gain)
    assert bilinear_cuda.adjoint_routes == {"planned": 0, "stream": 1}
    assert bilinear_cuda.off_plan_tiles(cuda) == bilinear_cuda.predict_off_plan_tiles(
        x, y, img.shape) > 0
    assert _rel(got, bilinear.bilinear_scatter_adjoint_plain(v, x, y, img.shape, gain)) < TOL


def test_destripe_cost_cuda_matches_cpu(cuda):
    """DestripeCost with K3 / K4 on the card against the same module on the
    CPU (the plain versions), and against its own plain route on the card:
    cost to rtol 1e-12, gradient to rtol 1e-9, atol 1e-12."""
    rng = np.random.default_rng(26)
    S, n = 3, 96
    imgs = rng.normal(size=(S, n, n))
    gains = rng.uniform(0.5, 2.0, (S, n, n))
    masks = rng.random((S, n, n)) > 0.1
    yy, xx = np.mgrid[0:n, 0:n].astype(float)
    pairs, xf, yf = [], [], []
    for i in range(S):
        for j in range(S):
            if i != j:
                th = 0.02 * (i - j)
                pairs.append((i, j))
                xf.append(np.cos(th) * xx - np.sin(th) * yy + 3.3 * (i - j))
                yf.append(np.sin(th) * xx + np.cos(th) * yy - 2.1 * (i - j))
    kw = dict(amp_cols=32, col_boundary_const=2.0)
    cpu = DestripeCost(imgs, gains, masks, pairs, xf, yf, device="cpu", **kw)
    bilinear_cuda.reset_launch_counts()
    gpu = DestripeCost(imgs, gains, masks, pairs, xf, yf, device=cuda, **kw)
    # a plan a pair on the card, by the plan kernel; none on the CPU
    assert bilinear_cuda.launches["bilinear_adjoint_plan"] == len(pairs)
    assert cpu.plans == [None] * len(pairs) and None not in gpu.plans
    p = rng.normal(scale=0.01, size=S * cpu.np_each)
    bilinear_cuda.reset_launch_counts()
    cost, grad = gpu.cost_and_grad(p)
    assert bilinear_cuda.launches == {"bilinear_gather": len(pairs),
                                      "bilinear_scatter_adjoint": len(pairs),
                                      "bilinear_gather.f32": 0,
                                      "bilinear_scatter_adjoint.f32": 0,
                                      "bilinear_adjoint_plan": 0,
                                      "bilinear_adjoint_plan.f32": 0}
    assert bilinear_cuda.adjoint_routes == {"planned": len(pairs), "stream": 0}
    want_cost, want_grad = cpu.cost_and_grad(p)
    np.testing.assert_allclose(cost, want_cost, rtol=1e-12)
    np.testing.assert_allclose(grad, want_grad, rtol=1e-9, atol=1e-12)
    e, g = gpu.value_and_grad(torch.as_tensor(p, device=cuda), plain=True)
    np.testing.assert_allclose(float(e), want_cost, rtol=1e-12)
    np.testing.assert_allclose(g.cpu().numpy(), want_grad, rtol=1e-9, atol=1e-12)


# the float32-position forms of K3 and K4: a stream (1-D, tiles of one row
# in K4's off-plan body), grids rolled by 0-90 degrees (ragged against K4's
# 32 x 32 tiles), and a grid scaled by 2.5 (the tiled body's global route, planned
# now); NaN, +-inf and off-grid positions, the last row and column among
# them, in every case
F32_CASES = ("stream", "roll0", "roll15", "roll45", "roll90", "global")


def _f32_case(cuda, kind):
    if kind == "stream":
        img, gain, x, y, v = _bil_case(cuda, 60)
    elif kind == "global":
        img, gain, x, y, v = _grid_case(cuda, 61, 30, ny=400, nx=420, scale=2.5)
    else:
        roll = int(kind[4:])
        img, gain, x, y, v = _grid_case(cuda, 62 + roll, roll)
    return img, gain, x.float(), y.float(), v


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("kind", F32_CASES)
def test_k3_k4_f32_forms_match_plain(cuda, kind, weighted):
    """K3 and K4 on float32 positions: one launch of each .f32 form, held to
    the plain versions (which widen the positions to float64); K3's f32
    form equals its f64 form on the widened positions bit for bit (the same
    float64 arithmetic, no atomics); K4's tiles off the plan are those
    predicted: a stream's, none of a grid's."""
    img, gain, x, y, v = _f32_case(cuda, kind)
    g = gain if weighted else None
    inb = bilinear.in_bounds(x, y, img.shape)
    assert int(inb.sum()) > 10_000 and int((~inb).sum()) > 100
    assert bool(torch.any(torch.isnan(x))) and bool(torch.any(torch.isinf(x)))
    bilinear_cuda.reset_launch_counts()
    bilinear_cuda.reset_off_plan_tiles()
    got3 = bilinear_cuda.bilinear_gather(img, x, y, g, out=v.clone())
    got4 = bilinear_cuda.bilinear_scatter_adjoint(v, x, y, img.shape, g)
    n_off = bilinear_cuda.off_plan_tiles(cuda)
    # a grid's plan built in the call: one launch of the plan kernel
    planned = bilinear_cuda.planned_route(*bilinear_cuda.query_grid(x))
    assert bilinear_cuda.launches == {"bilinear_gather": 0, "bilinear_scatter_adjoint": 0,
                                      "bilinear_gather.f32": 1,
                                      "bilinear_scatter_adjoint.f32": 1,
                                      "bilinear_adjoint_plan": 0,
                                      "bilinear_adjoint_plan.f32": int(planned)}
    assert _rel(got3, bilinear.bilinear_gather_plain(img, x, y, g) + v) < TOL
    assert _rel(got4, bilinear.bilinear_scatter_adjoint_plain(v, x, y, img.shape, g)) < TOL
    assert torch.equal(got3, bilinear_cuda.bilinear_gather(img, x.double(), y.double(), g,
                                                           out=v.clone()))
    assert n_off == bilinear_cuda.predict_off_plan_tiles(x, y, img.shape)
    assert (n_off > 0) == (kind == "stream")
    off = ~inb
    assert torch.all(bilinear_cuda.bilinear_gather(img, x, y, g)[off] == 0)


def test_f32_forms_raise_on_mixed_positions(cuda):
    img, _gain, x, y, v = _bil_case(cuda, 63, n=1000)
    with pytest.raises(TypeError):
        bilinear_cuda.bilinear_gather(img, x.float(), y)
    with pytest.raises(TypeError):
        bilinear_cuda.bilinear_scatter_adjoint(v, x, y.float(), img.shape)
    with pytest.raises(TypeError):
        bilinear_cuda.bilinear_gather(img, x.half(), y.half())


def _destripe_case(S=3, n=96, seed=26):
    rng = np.random.default_rng(seed)
    imgs = rng.normal(size=(S, n, n))
    gains = rng.uniform(0.5, 2.0, (S, n, n))
    masks = rng.random((S, n, n)) > 0.1
    yy, xx = np.mgrid[0:n, 0:n].astype(float)
    pairs, xf, yf = [], [], []
    for i in range(S):
        for j in range(S):
            if i != j:
                th = 0.02 * (i - j)
                pairs.append((i, j))
                xf.append(np.cos(th) * xx - np.sin(th) * yy + 3.3 * (i - j))
                yf.append(np.sin(th) * xx + np.cos(th) * yy - 2.1 * (i - j))
    return rng, imgs, gains, masks, pairs, xf, yf


@pytest.mark.parametrize("map_dtype, map_store", [("f64", "host"), ("f32", "device"),
                                                  ("f32", "host")])
def test_destripe_cost_storage_routes_on_the_card(cuda, map_dtype, map_store):
    """DestripeCost with its maps stored at float32 and / or streamed from
    pageable host memory, against the on-card float64 route on the same
    positions (float32 maps widened): cost to rtol 1e-12, gradient to rtol
    1e-9, atol 1e-12 (K4's atomics add in no fixed order); the launches are
    the storage's form, one a pair a pass; the host route holds no map on
    the card between passes, and its peak memory is under the float64
    device route's by at least the maps of all but two pairs."""
    rng, imgs, gains, masks, pairs, xf, yf = _destripe_case()
    if map_dtype == "f32":
        xf = [a.astype(np.float32) for a in xf]
        yf = [a.astype(np.float32) for a in yf]
    kw = dict(amp_cols=32, col_boundary_const=2.0)
    peaks = {}
    costs = {}
    for name, args in (("base", dict(xf=[a.astype(np.float64) for a in xf],
                                     yf=[a.astype(np.float64) for a in yf])),
                       ("route", dict(xf=xf, yf=yf, map_dtype=map_dtype,
                                      map_store=map_store))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(cuda)
        before = torch.cuda.memory_allocated(cuda)
        costs[name] = dc = DestripeCost(imgs, gains, masks, pairs, device=cuda, **kw, **args)
        p = torch.as_tensor(rng.normal(scale=0.01, size=len(imgs) * dc.np_each), device=cuda)
        dc.value_and_grad(p)
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated(cuda) - before
    base, route = costs["base"], costs["route"]
    p = rng.normal(scale=0.01, size=len(imgs) * base.np_each)
    bilinear_cuda.reset_launch_counts()
    cost, grad = route.cost_and_grad(p)
    suffix = ".f32" if map_dtype == "f32" else ""
    assert bilinear_cuda.launches["bilinear_gather" + suffix] == len(pairs)
    assert bilinear_cuda.launches["bilinear_scatter_adjoint" + suffix] == len(pairs)
    want_cost, want_grad = base.cost_and_grad(p)
    np.testing.assert_allclose(cost, want_cost, rtol=1e-12)
    np.testing.assert_allclose(grad, want_grad, rtol=1e-9, atol=1e-12)
    e, g = route.value_and_grad(torch.as_tensor(p, device=cuda), plain=True)
    np.testing.assert_allclose(float(e), want_cost, rtol=1e-12)
    np.testing.assert_allclose(g.cpu().numpy(), want_grad, rtol=1e-9, atol=1e-12)
    pair_bytes = 2 * imgs[0].size * (4 if map_dtype == "f32" else 8)
    if map_store == "host":
        # the hit counts, then two passes of a cost and gradient each
        assert route.maps.slots is None and route.maps.uploads == 5 * len(pairs)
        assert not any(t.is_pinned() for t in route.xf + route.yf)
    # within one f64 image plane of working memory
    assert peaks["route"] <= peaks["base"] - (len(pairs) - 2) * pair_bytes * (
        1 if map_store == "host" else 0.5) + 8 * imgs[0].size


def test_destripe_problem_memmap_on_the_card(cuda):
    """The user's route to the streamed maps, DestripeProblem(map_dtype=
    "f32", memmap=True) on the card: float32 maps in memory-mapped files,
    viewed in place (a write to a file shows in the cost's map) and
    uploaded pair by pair from those pageable pages, with K3 / K4's float32
    forms; against the on-card float64 route on the same positions (the
    maps widened): cost to rtol 1e-12, gradient to rtol 1e-9, atol 1e-12."""
    from pyimcom_tpu_torch import imdestripe
    from pyimcom_tpu_torch.wcsutil import WCS

    n = 128
    rng = np.random.default_rng(27)
    wcs = dict(ctype=("RA---TAN", "DEC--TAN"), crval=(150.0, 2.0),
               cd=np.array([[-4e-5, 0], [0, 4e-5]]), lonpole=180.0)
    scas = [imdestripe.Sca_img(rng.normal(size=(n, n)),
                               WCS(crpix=((n - 1) / 2 + dx, (n - 1) / 2 + dy), **wcs),
                               g_eff=rng.uniform(0.5, 2.0, (n, n)), name=f"sca{k}")
            for k, (dx, dy) in enumerate([(0, 0), (11, 4), (5, 13)])]
    prob = imdestripe.DestripeProblem(scas, {0: [1, 2], 1: [0, 2], 2: [0, 1]}, amp_cols=32,
                                      col_boundary_const=2.0, device=cuda, map_dtype="f32",
                                      memmap=True)
    dc = prob.device_cost
    P = len(dc.pairs)
    assert dc.map_store == "host" and dc.maps.uploads == P
    assert all(t.dtype == torch.float32 and not t.is_pinned() for t in dc.xf + dc.yf)
    i, j = dc.pairs[0]
    path = f"{prob.map_dir.name}/xf_{i}_{j}.dat"
    on_disk = np.memmap(path, dtype=np.float32, mode="r+")
    was = float(on_disk[5])
    on_disk[5] = -7.5
    assert float(dc.xf[0].reshape(-1)[5]) == -7.5
    on_disk[5] = was
    base = DestripeCost(np.stack([s.image for s in scas]), np.stack([s.g_eff for s in scas]),
                        None, dc.pairs, [t.double().numpy() for t in dc.xf],
                        [t.double().numpy() for t in dc.yf], amp_cols=32,
                        col_boundary_const=2.0, bmasks=[s.mask for s in scas], device=cuda)
    p = rng.normal(scale=0.01, size=prob.offsets[-1])
    bilinear_cuda.reset_launch_counts()
    cost, grad = prob.cost_and_grad(p)
    assert bilinear_cuda.launches["bilinear_gather.f32"] == P
    assert bilinear_cuda.launches["bilinear_scatter_adjoint.f32"] == P
    assert dc.maps.uploads == 3 * P and dc.maps.slots is None
    want_cost, want_grad = base.cost_and_grad(p)
    np.testing.assert_allclose(cost, want_cost, rtol=1e-12)
    np.testing.assert_allclose(grad, want_grad, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("map_dtype, map_store", [("f64", "device"), ("f32", "host")])
def test_destripe_cost_with_a_shrunk_pair_on_the_card(cuda, tmp_path, monkeypatch, map_dtype,
                                                      map_store):
    """A DestripeCost holding one pair shrunk 0.1x (its plan overflows)
    among five ordinary ones, its maps f64 on the card or f32 in memory-
    mapped files streamed from the host: the build reads every plan's
    counts back once (check_plans) and a gradient reads none (it runs under
    torch's sync debug mode "error"); value_and_grad matches the plain
    route within cost rtol 1e-12, gradient rtol 1e-9, atol 1e-12, with the
    shrunk pair's K4 off the plan (its tiles as predicted, read from the
    pair's uploaded maps where streamed) and the others' over their plans,
    and cost_and_grad gives the same numbers."""
    from pyimcom_tpu_torch.imdestripe import to_memmap
    from pyimcom_tpu_torch.ops import destripe_device

    rng, imgs, gains, masks, pairs, xf, yf = _destripe_case(n=320, seed=28)
    shrunk = 2
    yy, xx = np.mgrid[0:320, 0:320].astype(float)
    th = np.deg2rad(30)
    xf[shrunk] = 0.1 * (np.cos(th) * xx - np.sin(th) * yy) + 100.3
    yf[shrunk] = 0.1 * (np.sin(th) * xx + np.cos(th) * yy) + 100.2
    if map_store == "host":
        xf = [to_memmap(a.astype(np.float32), str(tmp_path), f"x{p}") for p, a in enumerate(xf)]
        yf = [to_memmap(a.astype(np.float32), str(tmp_path), f"y{p}") for p, a in enumerate(yf)]
    calls = []

    def counted(plans):
        calls.append(len(plans))
        bilinear_cuda.check_plans(plans)

    monkeypatch.setattr(destripe_device, "check_plans", counted)
    dc = DestripeCost(imgs, gains, masks, pairs, xf, yf, amp_cols=32, col_boundary_const=2.0,
                      device=cuda, map_dtype=map_dtype, map_store=map_store)
    assert calls == [len(pairs)]
    routes = [bilinear_cuda.plan_route(pl) for pl in dc.plans]
    assert routes == ["stream" if p == shrunk else "planned" for p in range(len(pairs))]
    maps = (dc.xf[shrunk], dc.yf[shrunk])
    n_off = bilinear_cuda.predict_off_plan_tiles(maps[0].to(cuda), maps[1].to(cuda), (320, 320))
    assert n_off > 0
    p = torch.as_tensor(rng.normal(scale=0.01, size=3 * dc.np_each), device=cuda)
    bilinear_cuda.reset_launch_counts()
    bilinear_cuda.reset_off_plan_tiles()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        e, g = dc.value_and_grad(p)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bilinear_cuda.adjoint_routes == {"planned": len(pairs) - 1, "stream": 1}
    assert bilinear_cuda.off_plan_tiles(cuda) == n_off
    e_p, g_p = dc.value_and_grad(p, plain=True)
    np.testing.assert_allclose(float(e), float(e_p), rtol=1e-12)
    np.testing.assert_allclose(g.cpu().numpy(), g_p.cpu().numpy(), rtol=1e-9, atol=1e-12)
    cost, grad = dc.cost_and_grad(p.cpu().numpy())
    assert calls == [len(pairs)]
    np.testing.assert_allclose(cost, float(e_p), rtol=1e-12)
    np.testing.assert_allclose(grad, g_p.cpu().numpy(), rtol=1e-9, atol=1e-12)


def test_pair_maps_uploads_wait_for_queued_work(cuda):
    """A walk's staging slots may reuse memory that work still queued on
    the current stream writes: here a NaN fill queued behind a device sleep
    into a tensor of the slots' size, freed before the walk.  The uploads
    on the side stream must wait for it, so every pair arrives intact."""
    from pyimcom_tpu_torch.ops.destripe_device import PairMaps

    rng = np.random.default_rng(64)
    P, ny, nx = 4, 512, 512
    xf = [torch.as_tensor(rng.uniform(0, nx, (ny, nx)), dtype=torch.float32).pin_memory()
          for _ in range(P)]
    yf = [torch.as_tensor(rng.uniform(0, ny, (ny, nx)), dtype=torch.float32).pin_memory()
          for _ in range(P)]
    maps = PairMaps(xf, yf, cuda)
    for _ in range(3):
        junk = torch.empty((2, 2, ny, nx), dtype=torch.float32, device=cuda)
        torch.cuda._sleep(20_000_000)
        junk.fill_(float("nan"))
        del junk
        seen = [(p, x.clone(), y.clone()) for p, x, y in maps.walk(range(P))]
        torch.cuda.synchronize()
        assert [p for p, _x, _y in seen] == list(range(P)) and maps.slots is None
        for p, x, y in seen:
            assert torch.equal(x.cpu(), xf[p]) and torch.equal(y.cpu(), yf[p]), p


def test_banded_block_on_one_card_matches_one_device(cuda, tmp_path):
    """The bench survey's block 1 at STOP 8 on ["cuda:0"] * 2 (two bands
    on one card: the banded path with its seam recompute and its round
    statistics) against the one-device block: science within 1e-12 of its
    scale, the maps to 1 LSB, no cross-device pool reuse."""
    from survey_fixture_torch import build_survey

    from pyimcom_tpu_torch.coadd import Block
    from pyimcom_tpu_torch.config import Config
    from pyimcom_tpu_torch.fitsio import fits_read

    cfg = build_survey(tmp_path, n_obs=8, extrainput=[],
                       config_overrides={"NPIXPSF": 16, "INPAD": 0.3, "STOP": 8})
    outs, blks = {}, {}
    for n in (1, 2):
        d = dict(cfg, OUT=cfg["OUT"] + f"_band{n}")
        blks[n] = Block(Config(d), this_sub=1, devices=[cuda] * n)
        outs[n] = fits_read(d["OUT"] + "_00_01.fits")
    assert blks[2]._cross_device_puts == 0 and blks[2]._round_stats is not None
    assert blks[2].pool_stats["recomputed"] > 0
    a = np.asarray(outs[1][0].data, np.float64)
    b = np.asarray(outs[2][0].data, np.float64)
    assert np.abs(b - a).max() <= 1e-12 * np.abs(a).max()
    for name in ("FIDELITY", "SIGMA", "INWTSUM", "EFFCOVER"):
        ha = [h for h in outs[1] if h.header.get("EXTNAME") == name]
        hb = [h for h in outs[2] if h.header.get("EXTNAME") == name]
        for x, y in zip(ha, hb):
            lsb = np.abs(np.asarray(x.data, np.float64) - np.asarray(y.data, np.float64))
            assert lsb.max() <= 1, name


def test_empirical_no_qlt_block_launches_no_kernel(cuda, tmp_path):
    """Empirical without quality control (EMPIRNQC) builds no system: one
    stamp of the reduced survey (no injected layer, so no star injection)
    launches neither K1 nor K2 on the card, and its science equals the CPU
    block's to 1e-12 of scale."""
    from survey_fixture_torch import build_survey

    from pyimcom_tpu_torch.coadd import Block
    from pyimcom_tpu_torch.config import Config
    from pyimcom_tpu_torch.fitsio import fits_read

    cfg = build_survey(tmp_path, n_obs=8, extrainput=[],
                       config_overrides={"NPIXPSF": 16, "INPAD": 0.3, "STOP": 1,
                                         "LAKERNEL": "Empirical", "EMPIRNQC": True})
    outs = {}
    for dev in ("cpu", cuda):
        d = dict(cfg, OUT=cfg["OUT"] + f"_{torch.device(dev).type}")
        interp_cuda.reset_launch_counts()
        blk = Block(Config(d), this_sub=1, device=dev)
        assert len(blk.stamp_stats) == 1
        assert all(n == 0 for n in interp_cuda.launches.values()), interp_cuda.launches
        outs[blk.device.type] = np.asarray(fits_read(d["OUT"] + "_00_01.fits")[0].data,
                                           np.float64)
    fin = np.isfinite(outs["cpu"])
    np.testing.assert_array_equal(np.isfinite(outs["cuda"]), fin)
    assert fin.any()
    assert _rel(torch.as_tensor(outs["cuda"][fin]), torch.as_tensor(outs["cpu"][fin])) < TOL


# --------------------------------------------------------------------------
# the G4460 forms: K1 and K2 with an 8 x 8 patch
# --------------------------------------------------------------------------

@pytest.mark.parametrize("lattice", [False, True], ids=["runs", "lattice"])
@pytest.mark.parametrize("kind", K1_SETS)
def test_k1_g4460_matches_plain(cuda, kind, lattice):
    """K1<8> against its plain version on the callers' query sets, in both
    run layouts, with odd and even image rows (sample reads and 16-byte
    pairs)."""
    for ns in (140, 141):
        images, x, y = k1_query_set(kind, 6, 40, ns, seed=30 + K1_SETS.index(kind))
        images, x, y = (torch.as_tensor(np.ascontiguousarray(a), device=cuda)
                        for a in (images, x, y))
        interp_cuda.reset_launch_counts()
        got = interp.interp2d_dense(images, x, y, "G4460", lattice_row=40 * lattice)
        assert interp_cuda.launches["interp_g4460_dense"] == 1
        assert interp_cuda.launches["interp_d5512_dense"] == 0
        want = interp_cuda.interp_dense_plain(images, x, y, "G4460")
        assert int((want != 0).sum()) > 0
        assert _rel(got, want) < TOL
        assert torch.equal(got == 0, want == 0)


def canvas_case(roll, scale=0.93867, side=90, A=120, seed=0, hole=False):
    """A block's points on a wing canvas, as CanvasGeometry.on_block picks
    them: an A x A canvas mapped into a side x side block (padded by 6 on
    every side: the image is (side + 12)^2) rolled by `roll` degrees and
    scaled, its points inside (-5.5, side + 4.5) kept, with their positions
    in the padded block; `hole` takes a slab out of the footprint (rows of
    two segments) and leaves a row of single points (many segments a
    tile).  Returns (image (1, n, n), x, y (1, Nq), CanvasSegments)."""
    rng = np.random.default_rng(seed)
    th = np.deg2rad(roll)
    gy, gx = np.mgrid[0:A, 0:A].astype(np.float64)
    u, w = gx - A / 2 + 0.3, gy - A / 2 - 0.2
    xb = scale * (np.cos(th) * u - np.sin(th) * w) + side / 2
    yb = scale * (np.sin(th) * u + np.cos(th) * w) + side / 2
    inside = (xb > -5.5) & (xb < side + 4.5) & (yb > -5.5) & (yb < side + 4.5)
    if hole:
        inside[A // 3:A // 2, A // 3:A // 2 + 5] = False
        inside[A // 2 + 3, :] = False
        inside[A // 2 + 3, ::3] = True
    idx = np.flatnonzero(inside)
    n = side + 12
    img = rng.normal(size=(1, n, n))
    x, y = xb.ravel()[idx] + 6, yb.ravel()[idx] + 6
    return img, x[None], y[None], interp_cuda.canvas_segments(idx, A, x, y)


def _canvas_against_runs(cuda, img, x, y, hint, kern="G4460", image=None):
    """The canvas body (counted as a K1 launch and a canvas route) against
    today's body, bit for bit, and the plain version (TOL)."""
    img, x, y = (torch.as_tensor(np.ascontiguousarray(a), device=cuda) for a in (img, x, y))
    if image is not None:
        img = image(img)
    interp_cuda.reset_launch_counts()
    got = interp.interp2d_dense(img, x, y, kern, segments=hint)
    assert interp_cuda.launches[interp_cuda.K1[kern]] == 1
    assert interp_cuda.dense_routes == {"runs": 0, "canvas": 1}
    runs = interp_cuda.interp_dense(img, x, y, kern)
    want = interp_cuda.interp_dense_plain(img, x, y, kern)
    assert int((want != 0).sum()) > 0
    assert torch.equal(got, runs)
    assert _rel(got, want) < TOL
    return got


@pytest.mark.parametrize("roll", [0, 30, 45, 90, 135])
def test_k1_canvas_body_matches_runs_and_plain(cuda, roll):
    """K1<8>'s canvas body on a block's canvas points at five rolls (the
    footprint's edges off the grid), with NaN and far-off queries mixed in,
    on even and odd image rows, with the half-warps along the lattice's
    rows and along its columns: bit for bit today's body, within TOL of the
    plain version; D5512 takes the same body."""
    for side in (90, 91):
        img, x, y, hint = canvas_case(roll, side=side, seed=roll + side)
        if roll % 45 or roll % 90 == 0:                   # 45, 135: a tie either way
            assert hint.transpose == (roll == 90)
        x[0, ::97] = np.nan
        y[0, 5::89] = 1e9
        for h in (hint, dataclasses.replace(hint, transpose=not hint.transpose)):
            _canvas_against_runs(cuda, img, x, y, h)
    img, x, y, hint = canvas_case(roll, seed=7)
    _canvas_against_runs(cuda, img, x, y, hint, kern="D5512")


def test_k1_canvas_body_split_rows_and_many_segments(cuda):
    """A footprint with a hole (rows of two segments) and a row of single
    points (a tile of more segments than one band may hold: the planner
    halves it), and an image not on 16 bytes (no staging: every patch read
    through L1 / L2)."""
    img, x, y, hint = canvas_case(20, hole=True, seed=3)
    assert np.bincount(hint.segments[:, 0]).max() > 30
    _canvas_against_runs(cuda, img, x, y, hint)

    def unaligned(im):
        buf = torch.empty(im.numel() + 1, dtype=im.dtype, device=im.device)
        out = buf[1:].view(im.shape)
        out.copy_(im)
        return out

    _canvas_against_runs(cuda, img, x, y, hint, image=unaligned)


@pytest.mark.parametrize("roll", [0, 45])
def test_k1_canvas_window_splits_its_tile(cuda, roll):
    """Points 3 samples apart: a 32 x 32 tile's window would outgrow the
    CTA's budget, so the planner cuts the tiles to 16 x 8 points, whose
    windows fit; tiles of 32 x 32 points given anyway read their patches
    through L1 / L2."""
    img, x, y, hint = canvas_case(roll, scale=3.0, side=400, A=150, seed=11 + roll)
    assert set(hint.tiles[:, 4]) == {8}
    _canvas_against_runs(cuda, img, x, y, hint)
    whole = dataclasses.replace(hint, tiles=interp_cuda.canvas_tiles(hint.segments))
    assert set(whole.tiles[:, 4]) == {32}
    _canvas_against_runs(cuda, img, x, y, whole)


def test_k1_canvas_hint_checks(cuda):
    """The hint takes one image, no lattice_row, and segments that lay out
    the queries once."""
    img, x, y, hint = canvas_case(10)
    img, x, y = (torch.as_tensor(a, device=cuda) for a in (img, x, y))
    with pytest.raises(ValueError):
        interp_cuda.interp_dense(img, x, y, "G4460", segments=hint, lattice_row=2)
    with pytest.raises(ValueError):
        interp_cuda.interp_dense(img, x[:, 1:].contiguous(), y[:, 1:].contiguous(), "G4460",
                                 segments=hint)
    with pytest.raises(ValueError):
        interp_cuda.interp_dense(img.expand(2, -1, -1).contiguous(), x.expand(2, -1).contiguous(),
                                 y.expand(2, -1).contiguous(), "G4460", segments=hint)


def test_k1_g4460_valid_range_edges(cuda):
    """Queries on both sides of each edge of G4460's valid range (3 <=
    floor(q) < n - 4) on the card: the kernel's zeros are the plain
    version's, so no edge query is dropped or read past the image."""
    rng = np.random.default_rng(40)
    for ny, nx in ((31, 29), (12, 13)):
        images = rng.normal(size=(2, ny, nx))
        fl_x = np.array([2, 3, 4, nx - 6, nx - 5, nx - 4, nx - 3])
        fl_y = np.array([2, 3, 4, ny - 6, ny - 5, ny - 4, ny - 3])
        fx, fy = (a.ravel() for a in np.meshgrid(fl_x, fl_y))
        x = np.stack([fx + rng.uniform(0, 1, fx.size)] * 2)
        y = np.stack([fy + rng.uniform(0, 1, fy.size)] * 2)
        images, x, y = (torch.as_tensor(a, device=cuda) for a in (images, x, y))
        got = interp_cuda.interp_dense(images, x, y, "G4460")
        want = interp_cuda.interp_dense_plain(images, x, y, "G4460")
        ok = (torch.floor(x) >= 3) & (torch.floor(x) < nx - 4) & \
            (torch.floor(y) >= 3) & (torch.floor(y) < ny - 4)
        assert torch.equal(want != 0, ok)
        assert torch.equal(got == 0, want == 0)
        assert _rel(got, want) < TOL


def _k2_special_case(cuda, case, kern):
    """Seeded K2 launches on the paths the main path rarely takes.
    'pool-pieces': one 32 x 32 tile whose i1 entries lie on a diagonal 100
    samples long, so that its window outgrows a slot and the kernel cuts it
    into pieces of fewer i1 (none from L2); 'pool-offgrid': rows whose
    queries all fall off the image or whose image index is out of range
    beside ordinary rows; 'pool-edges-nan': queries whose floors sit on both
    sides of each edge of the family's valid range, and NaN table entries;
    'B-row-ends': a B rectangle cut into rows in the middle of an i1, so
    that runs of i1 start and end inside the lattice.  Returns (dst size,
    the wrapper's arguments after dst, the tiles, the live query count)."""
    rng = np.random.default_rng(50 + len(case))
    K, ns = 3, 160 if case == "pool-pieces" else 96
    lo, hi = (3, 4) if kern == "G4460" else (4, 5)
    combined = torch.as_tensor(rng.normal(size=(K, ns, ns)), device=cuda)
    mode = 1 if case.startswith("B") else 0
    n2f, n_pad = 5, 40
    m = n2f * n2f
    L = 600
    xt, yt = rng.uniform(10, 14, L), rng.uniform(10, 14, L)
    inv_scale, off_grid = 1.0, 40.0
    if case == "pool-pieces":
        xt[:32] = np.linspace(-30, 110, 32)
        yt[:32] = np.linspace(-30, 110, 32)
        rows = [(0, 100, 32, 0, 32 * 32, 0)]
    elif case == "pool-offgrid":
        xt[200:240] += 300.0                        # these i1 fall off the image
        rows = [(0, 100, 30, 0, 900, 0), (200, 100, 30, 0, 900, 1),
                (300, 100, 30, 0, 900, K), (400, 100, 20, 5, 300, 2)]
    elif case == "pool-edges-nan":
        inv_scale, off_grid = 1.0, 0.0
        edges = np.array([lo - 1, lo, lo + 1, ns - hi - 2, ns - hi - 1, ns - hi], float)
        fx, fy = (a.ravel() for a in np.meshgrid(edges, edges))
        xt[:fx.size], yt[:fx.size] = fx + 0.3, fy + 0.6
        xt[100:104], yt[100:104] = [0.0, 0.25, 0.1, 0.05], [0.0, 0.1, 0.3, 0.2]
        xt[7], yt[19], xt[102] = np.nan, np.nan, np.nan
        rows = [(0, 100, 4, 0, fx.size * 4, 0), (0, 101, 3, 2, fx.size * 3 - 4, 1)]
    else:
        p = np.arange(m)
        xt[500:500 + m], yt[500:500 + m] = 2.0 + p % n2f, 3.0 + p // n2f
        chunk, w1 = 2 * m + 7, 23
        nq = w1 * m
        rows = [(10, 500, m, off, min(chunk, nq - off), int(rng.integers(0, K)))
                for off in range(0, nq, chunk)]
    imeta = np.array([(i1, i2, w2, off, nval) for i1, i2, w2, off, nval, _k in rows])
    ks = np.array([k for *_r, k in rows])
    if mode == 0:
        base = np.concatenate([[0], np.cumsum([r[2] * (-(-(r[3] + r[4]) // r[2])) + r[2]
                                               for r in rows])])[:-1]
        dmeta = np.stack([base, imeta[:, 2], imeta[:, 2], imeta[:, 3], imeta[:, 4]], 1)
        size = int(base[-1] + 2 * imeta[-1, 2] + imeta[-1, 3] + imeta[-1, 4])
    else:
        dmeta = np.stack([np.zeros(len(rows)), np.full(len(rows), 3), imeta[:, 3],
                          imeta[:, 4]], 1)
        size = m * n_pad

    def put(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=cuda)

    tiles = interp_cuda.sweep_tiles(imeta, mode, xt, yt, n2f)
    args = (combined, torch.as_tensor(xt, device=cuda), torch.as_tensor(yt, device=cuda),
            put(ks), put(imeta), put(dmeta), put(tiles), inv_scale, off_grid, mode, n_pad, n2f)
    return size, args, tiles, int(imeta[:, 4].sum())


K2_CASES = ["pool", "pool-l2", "B", "pool-pieces", "pool-offgrid", "pool-edges-nan",
            "B-row-ends"]


@pytest.mark.parametrize("kern", ["G4460", "D5512"])
@pytest.mark.parametrize("case", K2_CASES)
def test_k2_g4460_matches_plain(cuda, case, kern):
    """K2 in its G4460 form (and its D5512 instance, the same template)
    against its plain version: the rows of test_k2_matches_plain ('pool',
    'pool-l2': a window over a slot for a single i1, read from L2; 'B') and
    the paths of _k2_special_case -- a window over the ring's budget, cut
    into pieces; tiles with no valid query; NaN and edge queries at the
    valid range; runs of i1 that cross a row end in B mode.  The kernel's
    zeros are the plain version's."""
    if case in ("pool", "pool-l2", "B"):
        mode, spread = {"pool": (0, 20.0), "pool-l2": (0, 120.0), "B": (1, 20.0)}[case]
        size, args, tiles, nq = _k2_case(cuda, mode, spread)
        nq = int(nq.sum())
    else:
        size, args, tiles, nq = _k2_special_case(cuda, case, kern)
        mode = args[9]
    other = "D5512" if kern == "G4460" else "G4460"
    interp_cuda.reset_launch_counts()
    interp_cuda.reset_l2_tiles()
    got = interp_cuda.sweep_scatter(torch.zeros(size, dtype=torch.float64, device=cuda),
                                    *args, kern=kern)
    l2 = interp_cuda.l2_tiles(cuda)
    assert interp_cuda.launches[interp_cuda.sweep_kernel(kern, mode)] == 1
    assert interp_cuda.launches[interp_cuda.sweep_kernel(other, mode)] == 0
    want = interp_cuda.sweep_scatter_plain(
        torch.zeros(size, dtype=torch.float64, device=cuda), *args, kern=kern)
    torch.cuda.synchronize()
    least = {"pool-offgrid": nq // 4, "pool-edges-nan": 30}.get(case, nq // 2)
    assert int((want != 0).sum()) > least
    assert _rel(got, want) < TOL
    assert torch.equal(got == 0, want == 0)
    if mode == 0:
        assert (0 < l2 <= len(tiles)) if case == "pool-l2" else l2 == 0, (case, l2)
    if case == "pool-offgrid":
        # the off-grid rows and the row of image K add nothing
        assert int((want != 0).sum()) == 900 + 300
    if case == "B-row-ends":
        assert (tiles[:, 3] > 1).any() and len(tiles) > 1


def test_b_shared_memory_follows_the_family(cuda):
    """K2's B-mode shared memory, as the kernel library sizes it
    (k2_layout_torch.b_layout_bytes): x and y tap sets at the family's
    pitch (10 doubles for D5512, 9 for G4460) for a run of i1, two buffers
    of horizontal sums, the window, the int32 floors and the run's entries,
    two blocks an SM or, for the large windows of a PSF sampled 8x (2.909
    samples an output pixel), one; the compact layout of one i1 where that
    does not fit (n2f 54 at 2.13, 44 at 2.84); a lattice whose window
    outgrows the card's shared memory raises before any launch."""
    for kern, taps, pitch in (("D5512", 10, 10), ("G4460", 8, 9)):
        for n2f, scale in ((27, 2.18), (34, 2.13), (27, 2.909), (6, 1.7), (60, 2.5),
                           (54, 2.13), (44, 2.84)):
            w = interp_cuda.b_window(n2f, scale, kern)
            assert interp_cuda.b_smem_bytes(n2f, w, kern) == \
                b_layout_bytes(n2f, w, taps, pitch)
    size, args, _tiles, _nval = _k2_case(cuda, 1, 20.0)
    *head, inv_scale, off_grid, mode, n_pad, n2f = args
    interp_cuda.reset_launch_counts()
    with pytest.raises(ValueError, match="shared memory"):
        interp_cuda.sweep_scatter(torch.zeros(size, dtype=torch.float64, device=cuda),
                                  *head, 200.0, off_grid, mode, n_pad, n2f, kern="G4460")
    assert interp_cuda.launches[interp_cuda.sweep_kernel("G4460", 1)] == 0


@pytest.mark.parametrize("kern", ["G4460", "D5512"])
@pytest.mark.parametrize("n2f, scale", [(54, 2.13), (44, 2.84)], ids=["54-2.13", "44-2.84"])
def test_k2_b_large_windows_match_plain(cuda, kern, n2f, scale):
    """B mode on lattices whose one i1 does not fit beside two buffers of
    horizontal sums (OUTSIZE n2 48 with FADE 3 at oversampling 6, and n2
    38 at oversampling 8): the compact layout, with the bytes of the
    one-i1 body, against the plain version; rows cut in the middle of an
    i1."""
    rng = np.random.default_rng(n2f)
    m = n2f * n2f
    K, ns, L, n_pad = 3, 200, 1000 + m, 40
    lo = 1000
    pitch, taps = {"D5512": (10, 10), "G4460": (9, 8)}[kern]
    xt, yt = rng.uniform(0, 4, L), rng.uniform(0, 4, L)
    p = np.arange(m)
    xt[lo:], yt[lo:] = 5.0 + p % n2f, 6.0 + p // n2f
    xt[:lo] += 5.0 + (n2f - 1) / 2 - 2
    yt[:lo] += 6.0 + (n2f - 1) / 2 - 2
    w1, chunk = 14, 3 * m + 101
    nq = w1 * m
    offs = np.arange(0, nq, chunk)
    rows = len(offs)
    imeta = np.stack([np.full(rows, 20), np.full(rows, lo), np.full(rows, m), offs,
                      np.minimum(chunk, nq - offs)], 1)
    dmeta = np.stack([np.zeros(rows), np.full(rows, 3), offs, imeta[:, 4]], 1)
    ks = rng.integers(0, K, rows)
    wmax = interp_cuda.b_window(n2f, scale, kern)
    assert interp_cuda.b_smem_bytes(n2f, wmax, kern) == \
        8 * (2 * n2f * pitch + wmax * n2f + wmax * wmax) + 8 * n2f

    def put(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=cuda)

    tiles = interp_cuda.sweep_tiles(imeta, 1, xt, yt, n2f)
    args = (torch.as_tensor(rng.normal(size=(K, ns, ns)), device=cuda),
            torch.as_tensor(xt, device=cuda), torch.as_tensor(yt, device=cuda), put(ks),
            put(imeta), put(dmeta), put(tiles), scale, 100.0, 1, n_pad, n2f)
    size = m * n_pad
    interp_cuda.reset_launch_counts()
    got = interp_cuda.sweep_scatter(torch.zeros(size, dtype=torch.float64, device=cuda),
                                    *args, kern=kern)
    assert interp_cuda.launches[interp_cuda.sweep_kernel(kern, 1)] == 1
    want = interp_cuda.sweep_scatter_plain(
        torch.zeros(size, dtype=torch.float64, device=cuda), *args, kern=kern)
    torch.cuda.synchronize()
    assert int((want != 0).sum()) > nq // 2
    assert _rel(got, want) < TOL
    assert torch.equal(got == 0, want == 0)


def test_fftconvolve_multi_card_matches_cpu(cuda):
    """The wing convolution on cuFFT against the CPU route, at a canvas side
    with the factor 79 of the production canvases (2 * 3 * 79 = 474)."""
    from pyimcom_tpu_torch.splitpsf.imsubtract import fftconvolve_multi

    rng = np.random.default_rng(41)
    canvas, kernels = rng.normal(size=(474, 474)), rng.normal(size=(2, 60, 60))
    want = fftconvolve_multi(torch.as_tensor(canvas), torch.as_tensor(kernels))
    got = fftconvolve_multi(torch.as_tensor(canvas, device=cuda),
                            torch.as_tensor(kernels, device=cuda)).cpu()
    assert _rel(got, want) < TOL


def test_piff_draw_card_matches_cpu(cuda, tmp_path):
    """A batched Piff draw (a seeded order-2 PixelGrid, the block's stamp
    of 48 native pixels at oversampling 8) on the card against the CPU
    route: float32 stamps within one float32 spacing of max|stamp|."""
    from pyimcom_tpu_torch.utils import piffutils

    rng = np.random.default_rng(41)
    size = 41
    c = (size - 1) / 2.0
    yy, xx = np.mgrid[0:size, 0:size]
    g = np.exp(-0.5 * ((xx - c) ** 2 + (yy - c) ** 2) / 4.0 ** 2)
    q = 1e-3 * g.max() * rng.standard_normal((size * size, 6))
    q[:, 0] = g.ravel() / g.sum()
    piffutils.write_piff_file(str(tmp_path / "m.piff"), q, size, 2, scale=1.0 / 6)
    model = piffutils.PiffPSFModel(str(tmp_path / "m.piff"), 3)
    xs, ys = rng.uniform(0, 4087, 12), rng.uniform(0, 4087, 12)
    kw = dict(stamp_size=48, oversamp=8, normbox=5)
    got = np.stack(piffutils.draw_models([model] * 12, xs, ys, device=cuda, **kw))
    want = np.stack(piffutils.draw_models([model] * 12, xs, ys, device="cpu", **kw))
    assert got.dtype == want.dtype == np.float32 and got.shape == (12, 384, 384)
    assert np.abs(got.astype(np.float64) - want).max() <= np.spacing(np.abs(want).max())


def test_multiinterp_card_matches_cpu(cuda):
    """MultiInterp's gather on the card against the CPU route on a 2-layer
    float32 mosaic with a mask, a sheared map and extra smoothing, in two
    blocks of output pixels: within one float32 spacing of max|out|, the
    mask, Umax and Smax equal."""
    from pyimcom_tpu_torch.meta.ginterp import MultiInterp

    rng = np.random.default_rng(43)
    n = 160
    img = rng.standard_normal((2, n, n)).astype(np.float32)
    mask = rng.uniform(size=(n, n)) < 1e-3
    J = np.array([[1.02, 0.01], [-0.01, 0.98]])
    args = (img, mask, (140, 140), np.array([4.2, 3.7]), J, 6.0, 4.0, [0.6, 0.1, 0.5])
    got = MultiInterp(*args, blocksize=12000, device=cuda)
    want = MultiInterp(*args, blocksize=12000, device="cpu")
    assert got[0].dtype == np.float32
    assert np.abs(got[0].astype(np.float64) - want[0]).max() <= np.spacing(
        np.abs(want[0]).max())
    assert np.array_equal(got[1], want[1]) and not got[1].all()
    assert got[2:] == want[2:]


@pytest.mark.parametrize("indefinite", [False, True], ids=["spd", "indefinite"])
def test_mixed_solve_card_matches_cpu(cuda, indefinite):
    """cholesky_solve_mixed on CUDA tensors (cuSOLVER's float32 factor,
    float64 refinement) against the same solve on the CPU and against the
    card's float64 solve, on a seeded Gaussian-overlap system (n 300, one
    node at kappa/C 5e-4; shifted down by 1e-3 C, A is indefinite and
    takes the repair): U/C within 1e-6 and Sigma within 1e-4, the bounds
    of tests/test_solvers.py::test_mixed_precision_matches_f64."""
    from pyimcom_tpu_torch.solvers import cholesky_solve, cholesky_solve_mixed

    rng = np.random.default_rng(11)
    xin = rng.uniform(0, 12, (300, 2))
    xout = np.stack(np.meshgrid(np.linspace(4, 8, 5), np.linspace(4, 8, 5)), -1).reshape(-1, 2)
    sig = 1.2

    def ovl(p, q):
        d2 = ((p[:, None, :] - q[None, :, :]) ** 2).sum(-1)
        return np.exp(-d2 / (4 * sig ** 2)) / (4 * np.pi * sig ** 2)

    C = np.array([1.0 / (4 * np.pi * sig ** 2)])
    A = ovl(xin, xin) - (1e-3 * C[0] if indefinite else 0.0) * np.eye(len(xin))
    args = [np.ascontiguousarray(a) for a in (A, ovl(xout, xin)[None], C, np.array([5e-4]))]
    on = {dev: [torch.as_tensor(a, device=dev) for a in args] for dev in ("cpu", cuda)}
    got = cholesky_solve_mixed(*on[cuda], 1e-3, 1.0)
    for want in (cholesky_solve_mixed(*on["cpu"], 1e-3, 1.0),
                 cholesky_solve(*on[cuda], 1e-3, 1.0)):
        assert float((got[3].cpu() - want[3].cpu()).abs().max()) < 1e-6
        assert float((got[2].cpu() - want[2].cpu()).abs().max()) < 1e-4
    assert bool(torch.isfinite(got[0]).all())
