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

import numpy as np
import pytest
import torch

from pyimcom_tpu_torch import probe
from pyimcom_tpu_torch.ops import bilinear, bilinear_cuda, interp, interp_cuda
from pyimcom_tpu_torch.ops.destripe_device import DestripeCost

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
    assert bilinear_cuda.launches == {"bilinear_gather": 0, "bilinear_scatter_adjoint": 0}


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
    assert bilinear_cuda.launches == {"bilinear_gather": 1, "bilinear_scatter_adjoint": 1}
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
    """K4 on a 2-D query grid (the destripe pair's layout): one launch,
    every tile on the shared-memory route, held to the plain version."""
    img, gain, x, y, v = _grid_case(cuda, 40 + roll, roll)
    g = gain if weighted else None
    inb = bilinear.in_bounds(x, y, img.shape)
    assert int(inb.sum()) > 10_000 and int((~inb).sum()) > 1000
    assert bool(torch.any(x == img.shape[1] - 1)) and bool(torch.any(y == img.shape[0] - 1))
    assert int(torch.floor(x[inb]).max()) == img.shape[1] - 2      # the last column's taps
    assert int(torch.floor(y[inb]).max()) == img.shape[0] - 2      # the last row's
    bilinear_cuda.reset_launch_counts()
    bilinear_cuda.reset_global_tiles()
    got = bilinear_cuda.bilinear_scatter_adjoint(v, x, y, img.shape, g)
    assert bilinear_cuda.launches["bilinear_scatter_adjoint"] == 1
    assert bilinear_cuda.global_tiles(cuda) == 0
    assert bilinear_cuda.predict_global_tiles(x, y, img.shape) == 0
    assert _rel(got, bilinear.bilinear_scatter_adjoint_plain(v, x, y, img.shape, g)) < TOL


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_k4_global_route_when_the_box_outgrows_shared_memory(cuda, weighted):
    """A grid scaled by 2.5 gives tiles whose box outgrows the shared budget:
    they take the global route, counted as predict_global_tiles says; the
    15-degree pair grid takes none."""
    img, gain, x, y, v = _grid_case(cuda, 50, 30, ny=400, nx=420, scale=2.5)
    g = gain if weighted else None
    want = bilinear.bilinear_scatter_adjoint_plain(v, x, y, img.shape, g)
    bilinear_cuda.reset_global_tiles()
    got = bilinear_cuda.bilinear_scatter_adjoint(v, x, y, img.shape, g)
    n_global = bilinear_cuda.global_tiles(cuda)
    assert n_global > 0
    assert n_global == bilinear_cuda.predict_global_tiles(x, y, img.shape)
    assert _rel(got, want) < TOL
    img, gain, x, y, v = _grid_case(cuda, 51, 15)
    bilinear_cuda.reset_global_tiles()
    bilinear_cuda.bilinear_scatter_adjoint(v, x, y, img.shape, gain if weighted else None)
    assert bilinear_cuda.global_tiles(cuda) == 0


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_k3_k4_adjoint_identity_on_a_grid(cuda, weighted):
    img, gain, x, y, v = _grid_case(cuda, 52, 30)
    g = gain if weighted else None
    lhs = float(torch.sum(bilinear_cuda.bilinear_gather(img, x, y, g) * v))
    rhs = float(torch.sum(img * bilinear_cuda.bilinear_scatter_adjoint(v, x, y, img.shape, g)))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


def test_k4_one_row_stream_counts_its_global_tiles(cuda):
    """A 1-D stream is one row of queries, tiled 1 x 1024: on a flattened
    rotated grid a tile spans several of its rows, so its box outgrows
    shared memory and it takes the global route, as predicted."""
    img, gain, x, y, v = _bil_case(cuda, 53)
    bilinear_cuda.reset_global_tiles()
    got = bilinear_cuda.bilinear_scatter_adjoint(v, x, y, img.shape, gain)
    assert bilinear_cuda.global_tiles(cuda) == bilinear_cuda.predict_global_tiles(
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
    gpu = DestripeCost(imgs, gains, masks, pairs, xf, yf, device=cuda, **kw)
    p = rng.normal(scale=0.01, size=S * cpu.np_each)
    bilinear_cuda.reset_launch_counts()
    cost, grad = gpu.cost_and_grad(p)
    assert bilinear_cuda.launches == {"bilinear_gather": len(pairs),
                                      "bilinear_scatter_adjoint": len(pairs)}
    want_cost, want_grad = cpu.cost_and_grad(p)
    np.testing.assert_allclose(cost, want_cost, rtol=1e-12)
    np.testing.assert_allclose(grad, want_grad, rtol=1e-9, atol=1e-12)
    e, g = gpu.value_and_grad(torch.as_tensor(p, device=cuda), plain=True)
    np.testing.assert_allclose(float(e), want_cost, rtol=1e-12)
    np.testing.assert_allclose(g.cpu().numpy(), want_grad, rtol=1e-9, atol=1e-12)


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


@pytest.mark.parametrize("mode, spread", [(0, 20.0), (0, 120.0), (1, 20.0)],
                         ids=["pool", "pool-l2", "B"])
def test_k2_g4460_matches_plain(cuda, mode, spread):
    """K2 in its G4460 form against its plain version, on the rows of
    test_k2_matches_plain."""
    size, args, tiles, nval = _k2_case(cuda, mode, spread)
    interp_cuda.reset_launch_counts()
    got = interp_cuda.sweep_scatter(torch.zeros(size, dtype=torch.float64, device=cuda),
                                    *args, kern="G4460")
    assert interp_cuda.launches[interp_cuda.sweep_kernel("G4460", mode)] == 1
    assert interp_cuda.launches[interp_cuda.sweep_kernel("D5512", mode)] == 0
    want = interp_cuda.sweep_scatter_plain(
        torch.zeros(size, dtype=torch.float64, device=cuda), *args, kern="G4460")
    assert int((want != 0).sum()) > int(nval.sum()) // 2
    assert _rel(got, want) < TOL


def test_b_shared_memory_follows_the_family(cuda):
    """K2's B-mode shared memory, as the kernel library sizes it: x and y
    tap sets at the family's pitch (10 doubles for D5512, 9 for G4460),
    horizontal sums, the window and the int32 floors; a lattice whose
    window outgrows the card's shared memory raises before any launch."""
    for kern, pitch in (("D5512", 10), ("G4460", 9)):
        w = interp_cuda.b_window(27, 2.18, kern)
        assert interp_cuda.b_smem_bytes(27, w, kern) == \
            8 * (2 * pitch * 27 + w * 27 + w * w) + 8 * 27
    size, args, _tiles, _nval = _k2_case(cuda, 1, 20.0)
    *head, inv_scale, off_grid, mode, n_pad, n2f = args
    interp_cuda.reset_launch_counts()
    with pytest.raises(ValueError, match="shared memory"):
        interp_cuda.sweep_scatter(torch.zeros(size, dtype=torch.float64, device=cuda),
                                  *head, 200.0, off_grid, mode, n_pad, n2f, kern="G4460")
    assert interp_cuda.launches[interp_cuda.sweep_kernel("G4460", 1)] == 0


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
