"""The G4460 interpolation family of pyimcom_tpu_torch against the JAX
package's.

G4460 is the 8-tap family (valid iff 3 <= floor(q) < ng - 4); the port's
gather forms, its dense entry (K1's plain version on the CPU) and K2's
plain version take it by name.  The same seeded inputs go through both
packages in float64 on the CPU: the interpolated values agree to 1e-13 of
the image scale (two summation orders of the same taps) and vanish at the
same queries, including queries on both sides of each edge of the valid
range (floor(q) in {2, 3, 4, ng-6, ng-5, ng-4, ng-3}).  The tone-error
contract of the family (3.5e-6 for u <= 1/8) and the partition of unity
(5e-6) are the JAX package's own bounds (tests/test_interp.py:144-206).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyimcom_tpu.ops import assemble as ref_assemble
from pyimcom_tpu.ops import interp as ref
from pyimcom_tpu_torch.convert import from_numpy
from pyimcom_tpu_torch.ops import assemble, interp, interp_cuda
from test_torch_assemble import sweep_case  # noqa: F401  (fixture)

torch.set_num_threads(1)
CPU = torch.device("cpu")
TOL = 1e-13


def _t(a):
    return from_numpy(a, CPU)


def _close(got, want, scale):
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)
    np.testing.assert_array_equal(got == 0.0, want == 0.0)


def edge_scene(seed, ny=31, nx=29):
    """An (ny, nx) image and queries whose floors sit on both sides of each
    edge of G4460's valid range on each axis, plus random ones inside."""
    rng = np.random.default_rng(seed)
    image = rng.normal(size=(ny, nx))
    floors_x = np.array([2, 3, 4, nx - 6, nx - 5, nx - 4, nx - 3])
    floors_y = np.array([2, 3, 4, ny - 6, ny - 5, ny - 4, ny - 3])
    fx, fy = (a.ravel() for a in np.meshgrid(floors_x, floors_y))
    x = np.concatenate([fx + rng.uniform(0, 1, fx.size), rng.uniform(3, nx - 4, 60)])
    y = np.concatenate([fy + rng.uniform(0, 1, fy.size), rng.uniform(3, ny - 4, 60)])
    return image, x, y


def g4460_port_vs_ref(fn, image, x, y):
    """The port's `fn` ("interp2d", "grid_interp" or "interp2d_dense") with
    kern "G4460" against the JAX package's, on the same inputs."""
    scale = np.abs(image).max()
    if fn == "interp2d":
        got = interp.interp2d(_t(image), _t(x), _t(y), kern="G4460").numpy()
        want = np.asarray(ref.interp2d(jnp.asarray(image), jnp.asarray(x),
                                       jnp.asarray(y), "G4460"))
    elif fn == "interp2d_dense":
        n = x.size // 2 * 2
        xr, yr = x[:n].reshape(2, -1), y[:n].reshape(2, -1)
        images = np.stack([image, -0.5 * image])
        interp_cuda.reset_launch_counts()
        got = interp.interp2d_dense(_t(images), _t(xr), _t(yr), kern="G4460").numpy()
        assert interp_cuda.launches["interp_g4460_dense"] == 0       # CPU: plain
        want = np.asarray(ref.interp2d_dense(jnp.asarray(images), jnp.asarray(xr),
                                             jnp.asarray(yr), "G4460"))
    else:
        P = 7
        gx = x[:P * 8].reshape(P, 8)
        gy = y[:P * 9][::-1].reshape(P, 9).copy()
        got = interp.grid_interp(_t(image), _t(gx), _t(gy), kern="G4460").numpy()
        want = np.asarray(ref.grid_interp(jnp.asarray(image), jnp.asarray(gx),
                                          jnp.asarray(gy), "G4460"))
    assert 0 < int((want != 0).sum()) < want.size          # on and off the range
    _close(got, want, scale)


def test_g4460_constants_match_reference():
    np.testing.assert_array_equal(interp.G4460_EVEN, ref.G4460_EVEN)
    np.testing.assert_array_equal(interp.G4460_ODD, ref.G4460_ODD)
    for kern in ("D5512", "G4460"):
        assert interp.KERNEL_FAMILIES[kern][2:] == ref.KERNEL_FAMILIES[kern][2:]
        np.testing.assert_array_equal(interp.KERNEL_FAMILIES[kern][0],
                                      ref.KERNEL_FAMILIES[kern][0])


def test_g4460_weights_sum_and_symmetry():
    fh = np.linspace(-0.5, 0.5, 41)
    w = interp.kernel_weights(_t(fh), "G4460").numpy()
    assert w.shape == (41, 8)
    np.testing.assert_allclose(w.sum(axis=-1), 1.0, rtol=0, atol=5e-6)
    np.testing.assert_allclose(w, interp.kernel_weights(_t(-fh), "G4460").numpy()[:, ::-1],
                               rtol=0, atol=1e-14)
    np.testing.assert_allclose(w, np.asarray(ref.kernel_weights(jnp.asarray(fh), "G4460")),
                               rtol=0, atol=1e-15)


def test_g4460_bandlimited_accuracy():
    """Tone error below 3.5e-6 for u <= 1/8 cycles/sample, and the JAX
    package's values to 1e-13."""
    rng = np.random.default_rng(7)
    ny = nx = 64
    yy, xx = np.mgrid[0:ny, 0:nx]
    x = rng.uniform(10, 50, 400)
    y = rng.uniform(10, 50, 400)
    for (u, v) in [(1 / 14, 1 / 16), (1 / 12, 0.0), (0.088, 0.088 / 2)]:
        image = np.cos(2 * np.pi * (u * xx + v * yy) + 0.37)
        want = np.cos(2 * np.pi * (u * x + v * y) + 0.37)
        got = interp.interp2d(_t(image), _t(x), _t(y), "G4460").numpy()
        assert np.abs(got - want).max() < 3.5e-6
        np.testing.assert_allclose(got, np.asarray(ref.interp2d(
            jnp.asarray(image), jnp.asarray(x), jnp.asarray(y), "G4460")), rtol=0, atol=TOL)


def test_g4460_dense_matches_gather_path():
    rng = np.random.default_rng(3)
    image = rng.standard_normal((40, 44))
    x = rng.uniform(0, 44, 300)   # includes off-grid queries
    y = rng.uniform(0, 40, 300)
    a = interp.interp2d(_t(image), _t(x), _t(y), "G4460").numpy()
    b = interp.interp2d_dense(_t(image)[None], _t(x)[None], _t(y)[None], "G4460").numpy()[0]
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-15 * np.abs(image).max())
    want = np.asarray(ref.interp2d_dense(jnp.asarray(image)[None], jnp.asarray(x)[None],
                                         jnp.asarray(y)[None], "G4460"))[0]
    _close(b, want, np.abs(image).max())


def test_g4460_grid_interp_matches_pointwise():
    rng = np.random.default_rng(5)
    image = rng.standard_normal((32, 32))
    P, nyo, nxo = 3, 4, 5
    x = rng.uniform(8, 24, (P, nxo))
    y = rng.uniform(8, 24, (P, nyo))
    got = interp.grid_interp(_t(image), _t(x), _t(y), "G4460").numpy()
    for p in range(P):
        xm, ym = np.meshgrid(x[p], y[p])
        want = interp.interp2d(_t(image), _t(xm.ravel()), _t(ym.ravel()),
                               "G4460").numpy().reshape(nyo, nxo)
        np.testing.assert_allclose(got[p], want, rtol=0, atol=1e-15)
    np.testing.assert_allclose(got, np.asarray(ref.grid_interp(
        jnp.asarray(image), jnp.asarray(x), jnp.asarray(y), "G4460")), rtol=0, atol=TOL)


@pytest.mark.parametrize("fn", ["interp2d", "interp2d_dense", "grid_interp"])
@pytest.mark.parametrize("shape", [(31, 29), (12, 13)], ids=["31x29", "12x13"])
def test_g4460_edge_queries_match_reference(fn, shape):
    """Queries on both sides of each edge of the valid range, on an image
    large enough for all seven floors and on one where the ranges of the
    edges meet."""
    g4460_port_vs_ref(fn, *edge_scene(23, *shape))


def test_g4460_sweep_pool_matches_reference(sweep_case):  # noqa: F811
    """K2's plain version in its G4460 form against the JAX sweep with kern
    "G4460", on the pool rows of tests/test_torch_assemble.py."""
    c = sweep_case
    tabs = [jnp.asarray(t) for t in ref_assemble.split_tables(c["xt"], c["yt"])]
    want = np.asarray(ref_assemble.sweep_pool_scan(
        jnp.zeros(c["P"]), jnp.asarray(c["combined"]), *tabs,
        jnp.asarray(c["ks"]), jnp.asarray(c["im_p"]), jnp.asarray(c["pmeta"]),
        c["inv_scale"], c["off_grid"], c["bucket"], "G4460"))
    interp_cuda.reset_launch_counts()
    got = assemble.sweep_pool(
        torch.zeros(c["P"], dtype=torch.float64), _t(c["combined"]), _t(c["xt"]),
        _t(c["yt"]), _t(c["ks"]), _t(c["im_p"]), _t(c["pmeta"]),
        _t(interp_cuda.sweep_tiles(c["im_p"], 0)), c["inv_scale"], c["off_grid"],
        "G4460").numpy()
    assert interp_cuda.launches["sweep_g4460_scatter.pool"] == 0   # CPU: plain
    assert np.count_nonzero(want) > 50
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_g4460_sweep_b_matches_reference(sweep_case):  # noqa: F811
    c = sweep_case
    nB = c["m"] * c["n_pad"]
    want = np.asarray(ref_assemble.sweep_b_scan(
        jnp.zeros(nB), jnp.asarray(c["combined"]), jnp.asarray(c["xt"]),
        jnp.asarray(c["yt"]), jnp.asarray(c["ks"]), jnp.asarray(c["im_b"]),
        jnp.asarray(c["bmeta"]), c["inv_scale"], c["off_grid"], c["bucket"],
        "G4460", c["n_pad"], c["m"]))
    got = assemble.sweep_b(
        torch.zeros(nB, dtype=torch.float64), _t(c["combined"]), _t(c["xt"]),
        _t(c["yt"]), _t(c["ks"]), _t(c["im_b"]), _t(c["bmeta"]),
        _t(interp_cuda.sweep_tiles(c["im_b"], 1, c["xt"], c["yt"], c["n2f"])),
        c["inv_scale"], c["off_grid"], c["n_pad"], c["n2f"], "G4460").numpy()
    assert np.count_nonzero(want) > 50
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_b_window_and_shared_memory_follow_the_family():
    """K2's B-mode window guard is the family's tap count (+2 for the
    floors' rounding), and each family and mode has its own launch count
    (the shared memory that the window needs is the kernel library's:
    tests/test_torch_cuda.py)."""
    for kern, taps in (("D5512", 10), ("G4460", 8)):
        assert interp_cuda.b_window(27, 2.18, kern) == int(26 * 2.18) + 2 + taps
    assert interp_cuda.sweep_kernel("G4460", 0) == "sweep_g4460_scatter.pool"
    assert interp_cuda.sweep_kernel("D5512", 1) == "sweep_d5512_scatter.B"
    assert {interp_cuda.sweep_kernel(k, m) for k in ("D5512", "G4460") for m in (0, 1)} \
        <= set(interp_cuda.launches)
