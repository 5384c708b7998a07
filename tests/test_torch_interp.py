"""pyimcom_tpu_torch.ops.interp against the JAX package's interpolation.

The same seeded inputs go through both packages in float64 on the CPU.
The port's gather forms agree with the reference to 1e-12 of the image
scale (rounding of two summation orders); the Pallas kernel, run in
interpret mode, is held to its own f32-phase bound of 3e-6 of scale
(tests/test_pallas.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyimcom_tpu.ops import interp as ref
from pyimcom_tpu.ops.interp_pallas import interp2d_dense_pallas
from pyimcom_tpu_torch.convert import from_numpy
from pyimcom_tpu_torch.ops import interp, interp_cuda
from test_torch_cuda import K1_SETS, k1_query_set

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _t(a):
    return from_numpy(a, CPU)


def test_d5512_constants_match_reference():
    np.testing.assert_array_equal(interp.D5512_EVEN, ref.D5512_EVEN)
    np.testing.assert_array_equal(interp.D5512_ODD, ref.D5512_ODD)
    assert (interp._LO, interp._HI_MARGIN, interp.KERNEL_SIZE) == \
        (ref._LO, ref._HI_MARGIN, ref.KERNEL_SIZE)


def test_kernel_weights_match_reference():
    fh = np.random.default_rng(0).uniform(-0.5, 0.5, 257)
    got = interp.kernel_weights(_t(fh)).numpy()
    want = np.asarray(ref.kernel_weights(jnp.asarray(fh)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(1)
    K, ny, nx, N = 3, 41, 37, 600
    images = rng.normal(size=(K, ny, nx))
    # queries cover the grid and spill past both edges (off-grid zeros)
    x = rng.uniform(-3, nx + 3, N)
    y = rng.uniform(-3, ny + 3, N)
    which = rng.integers(0, K, N).astype(np.int32)
    return images, x, y, which


def _close(got, want, scale):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * scale)
    np.testing.assert_array_equal(got == 0.0, want == 0.0)


def test_interp2d_matches_reference(scene):
    images, x, y, _ = scene
    got = interp.interp2d(_t(images[0]), _t(x), _t(y)).numpy()
    want = np.asarray(ref.interp2d(jnp.asarray(images[0]), jnp.asarray(x),
                                   jnp.asarray(y)))
    _close(got, want, np.abs(images).max())


def test_interp2d_stack_matches_reference(scene):
    images, x, y, which = scene
    got = interp.interp2d_stack(_t(images), _t(x), _t(y), _t(which)).numpy()
    want = np.asarray(ref.interp2d_stack(jnp.asarray(images), jnp.asarray(x),
                                         jnp.asarray(y), jnp.asarray(which)))
    _close(got, want, np.abs(images).max())


def test_grid_interp_matches_reference(scene):
    images, _, _, _ = scene
    rng = np.random.default_rng(2)
    gx = rng.uniform(-2, 39, (4, 15))
    gy = rng.uniform(-2, 43, (4, 11))
    got = interp.grid_interp(_t(images[1]), _t(gx), _t(gy)).numpy()
    want = np.asarray(ref.grid_interp(jnp.asarray(images[1]), jnp.asarray(gx),
                                      jnp.asarray(gy)))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(images).max())


def test_interp2d_dense_matches_reference(scene):
    """The dense entry on a CPU tensor runs K1's plain version."""
    images, x, y, _ = scene
    xr, yr = x[:540].reshape(3, 180), y[:540].reshape(3, 180)
    interp_cuda.reset_launch_counts()
    got = interp.interp2d_dense(_t(images), _t(xr), _t(yr)).numpy()
    assert interp_cuda.launches["interp_d5512_dense"] == 0
    want = np.asarray(ref.interp2d_dense(jnp.asarray(images), jnp.asarray(xr),
                                         jnp.asarray(yr)))
    _close(got, want, np.abs(images).max())


def test_interp2d_dense_matches_pallas_interpret():
    """Against the Pallas kernel itself, at its (8, 128) tile alignment."""
    rng = np.random.default_rng(3)
    R, Nq, ns = 8, 256, 47
    images = rng.normal(size=(R, ns, ns))
    x = rng.uniform(-5, ns + 5, (R, Nq))
    y = rng.uniform(-5, ns + 5, (R, Nq))
    got = interp.interp2d_dense(_t(images), _t(x), _t(y)).numpy()
    pal = np.asarray(interp2d_dense_pallas(jnp.asarray(images), jnp.asarray(x),
                                           jnp.asarray(y), interpret=True))
    scale = np.abs(images).max()
    np.testing.assert_allclose(got, pal, rtol=0, atol=3e-6 * scale)
    np.testing.assert_array_equal(got == 0.0, pal == 0.0)


@pytest.mark.parametrize("kind", K1_SETS)
def test_k1_plain_matches_reference_on_main_path_sets(kind):
    """K1's plain version, through the dense entry on CPU tensors with the
    lattice row its callers pass, on the query sets of its callers (the
    rotated PSF sampling lattice, a star patch, random points;
    tests/test_torch_cuda.py holds the kernel to this plain version on the
    card): against the JAX package's dense entry in f64 to 1e-12 of scale,
    and against its Pallas kernel in interpret mode to that kernel's
    f32-phase bound."""
    images, x, y = k1_query_set(kind, 8, 16, 47, seed=20 + K1_SETS.index(kind))
    interp_cuda.reset_launch_counts()
    got = interp.interp2d_dense(_t(images), _t(x), _t(y),
                                lattice_row=0 if kind == "random" else 16).numpy()
    assert interp_cuda.launches["interp_d5512_dense"] == 0
    scale = np.abs(images).max()
    assert 0 < int((got != 0).sum()) < got.size      # on and off the grid
    want = np.asarray(ref.interp2d_dense(jnp.asarray(images), jnp.asarray(x),
                                         jnp.asarray(y)))
    _close(got, want, scale)
    pal = np.asarray(interp2d_dense_pallas(jnp.asarray(images), jnp.asarray(x),
                                           jnp.asarray(y), interpret=True))
    np.testing.assert_allclose(got, pal, rtol=0, atol=3e-6 * scale)
    np.testing.assert_array_equal(got == 0.0, pal == 0.0)


def test_kernel_wrappers_take_cuda_tensors_only():
    """A CPU tensor never reaches the CUDA wrappers' launch (nor the build):
    they raise, and the CPU route is the callers' plain version."""
    z3 = torch.zeros((1, 16, 16), dtype=torch.float64)
    q = torch.zeros((1, 4), dtype=torch.float64)
    i32 = torch.zeros((1, 5), dtype=torch.int32)
    for kern in ("D5512", "G4460"):
        with pytest.raises(ValueError, match="CUDA"):
            interp_cuda.interp_dense(z3, q, q, kern)
        with pytest.raises(ValueError, match="CUDA"):
            interp_cuda.sweep_scatter(torch.zeros(8, dtype=torch.float64), z3, q[0], q[0],
                                      i32[:, 0], i32, i32, i32, 1.0, 0.0, 0, kern=kern)
    assert interp_cuda.launches == {"interp_d5512_dense": 0,
                                    "sweep_d5512_scatter.pool": 0,
                                    "sweep_d5512_scatter.B": 0,
                                    "interp_g4460_dense": 0,
                                    "sweep_g4460_scatter.pool": 0,
                                    "sweep_g4460_scatter.B": 0}


@pytest.mark.parametrize("fn", ["interp2d", "grid_interp", "interp2d_dense", "unknown"])
def test_other_kernel_families_raise(fn):
    """The G4460 family is ported: each entry that raised for it now
    matches the JAX package's G4460 form to 1e-13 of the image scale, with
    queries on both sides of each edge of its valid range (3 <= floor(q) <
    ng - 4); a family outside KERNEL_FAMILIES still raises."""
    z = torch.zeros((1, 16, 16), dtype=torch.float64)
    q = torch.zeros((1, 4), dtype=torch.float64)
    if fn == "unknown":
        for name, args in {"interp2d": (z[0], q[0], q[0]), "grid_interp": (z[0], q, q),
                           "interp2d_dense": (z, q, q)}.items():
            with pytest.raises(ValueError, match="unknown interpolation kernel"):
                getattr(interp, name)(*args, kern="X9999")
        return
    from test_torch_g4460 import edge_scene, g4460_port_vs_ref

    g4460_port_vs_ref(fn, *edge_scene(seed=11))
