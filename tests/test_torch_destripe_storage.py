"""The storage of pyimcom_tpu_torch's destripe pair maps: float32 maps
(``map_dtype="f32"``) and maps kept in host memory and streamed to the
device pair by pair (``map_store="host"``, memory-mapped files with
``DestripeProblem(memmap=True)``), against the JAX package's
PYIMCOM_DESTRIPE_MAP_DTYPE / PYIMCOM_DESTRIPE_MEMMAP and against the port's
own float64 on-device route, on the seeded three-SCA problem of
tests/test_torch_destripe.py, in float64 on the CPU.

Bounds.  The port's f32 + memmap problem against the JAX package's under
both switches: maps bit for bit, the cost to rtol 1e-12 and the gradient
to rtol 1e-9 / atol 1e-12 (the JAX package's bounds between its routes),
and the JAX test's finite-difference check.  Every storage route against
the float64 on-device route given the same positions: 1e-14 of the cost
and of the gradient's scale (the same float64 arithmetic; the host route
sums a source image's pair adjoints in its own order).  Across dtypes the
"same positions" are the float32 maps widened to float64, which is exact:
against the float64 maps themselves no rounding bound holds on this
problem, because its integer dithers put the maps within 1e-9 pixel of
integers, and rounding to float32 moves 177 positions onto the last
column, x = nx - 1, which is out of bounds; the hit counts change there
(the JAX package's f32 maps do the same).
"""

import os

import numpy as np
import pytest
import torch

from test_torch_destripe import SIZE, _arrays, _case, _points, _port_problem, _ref_problem, _t

from pyimcom_tpu_torch.ops import bilinear
from pyimcom_tpu_torch.ops.destripe_device import DestripeCost

torch.set_num_threads(1)


def test_map_dtype_and_memmap_matches_jax(monkeypatch):
    """Twin of tests/test_imdestripe.py::test_map_dtype_and_memmap."""
    monkeypatch.setenv("PYIMCOM_DESTRIPE_MAP_DTYPE", "f32")
    monkeypatch.setenv("PYIMCOM_DESTRIPE_MEMMAP", "1")
    imgs, _stripes, rng = _arrays(26)
    jref = _ref_problem(imgs)
    port = _port_problem(imgs, map_dtype="f32", memmap=True)
    dc = port.device_cost
    assert dc.map_store == "host" and dc.map_dtype == "f32"
    files = sorted(os.listdir(port.map_dir.name))
    assert len(files) == 2 * len(dc.pairs)
    for p, (i, j) in enumerate(dc.pairs):
        xf, yf, _inb = jref._maps[(i, j)]
        assert isinstance(xf, np.memmap) and xf.dtype == np.float32
        for got, want, tag in ((dc.xf[p], xf, "xf"), (dc.yf[p], yf, "yf")):
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want).reshape(SIZE, SIZE))
            on_disk = np.memmap(os.path.join(port.map_dir.name, f"{tag}_{i}_{j}.dat"),
                                dtype=np.float32, mode="r")
            np.testing.assert_array_equal(on_disk.reshape(SIZE, SIZE), got.numpy())
    # the host route views the files in place: a write to one shows in its map
    i, j = dc.pairs[0]
    on_disk = np.memmap(os.path.join(port.map_dir.name, f"xf_{i}_{j}.dat"), dtype=np.float32,
                        mode="r+")
    was = float(on_disk[7])
    on_disk[7] = -7.5
    assert float(dc.xf[0].reshape(-1)[7]) == -7.5
    on_disk[7] = was
    del on_disk
    p = rng.normal(scale=0.01, size=port.offsets[-1])
    cost, grad = port.cost_and_grad(p)
    np.testing.assert_allclose(cost, jref.cost(p), rtol=1e-12)
    np.testing.assert_allclose(grad, jref.gradient(p), rtol=1e-9, atol=1e-12)
    for idx in [3, 150]:
        h = 1e-5
        dp = np.zeros_like(p)
        dp[idx] = h
        fd = (port.cost(p + dp) - port.cost(p - dp)) / (2 * h)
        assert abs(fd - grad[idx]) < 1e-3 * max(1.0, abs(fd)), (idx, fd, grad[idx])
    map_dir = port.map_dir.name
    del port, dc
    import gc

    gc.collect()
    assert not os.path.exists(map_dir), "the maps' directory goes with the problem"


def _cost(prob, xf, yf, **kw):
    """A DestripeCost of `prob`'s images on the given maps."""
    mask = prob.mask
    return DestripeCost(np.stack([s.image for s in prob.scas]),
                        np.stack([s.g_eff for s in prob.scas]),
                        None if mask is None else np.stack(mask), prob.device_cost.pairs, xf, yf,
                        amp_cols=prob.amp_cols, cost_model=prob.cost_model, hub=prob.hub,
                        col_boundary_const=prob.col_boundary_const,
                        bmasks=[mask[i] if mask is not None else s.mask
                                for i, s in enumerate(prob.scas)], device="cpu", **kw)


def _close(got, want, rel):
    (e1, g1), (e0, g0) = got, want
    assert abs(float(e1) - float(e0)) <= rel * abs(float(e0)), (float(e1), float(e0))
    assert float((g1 - g0).abs().max()) <= rel * float(g0.abs().max())


@pytest.mark.parametrize("map_store", ["device", "host"])
@pytest.mark.parametrize("map_dtype", ["f64", "f32"])
@pytest.mark.parametrize("name", ["uniform", "gain", "amp_cols"])
def test_storage_routes_match_the_device_f64_route(name, map_dtype, map_store):
    imgs, gains, kw = _case(name)
    prob = _port_problem(imgs, gains, **kw)
    base = prob.device_cost
    xf = [m.numpy() for m in base.xf]
    yf = [m.numpy() for m in base.yf]
    if map_dtype == "f32":
        # the float64 route on the float32 maps, widened exactly
        xf = [m.astype(np.float32) for m in xf]
        yf = [m.astype(np.float32) for m in yf]
        base = _cost(prob, [m.astype(np.float64) for m in xf],
                     [m.astype(np.float64) for m in yf])
    dc = _cost(prob, xf, yf, map_dtype=map_dtype, map_store=map_store)
    for p in range(len(dc.pairs)):
        assert dc.xf[p].dtype == (torch.float32 if map_dtype == "f32" else torch.float64)
        np.testing.assert_array_equal(dc.xf[p].numpy(), xf[p])
        np.testing.assert_array_equal(dc.yf[p].numpy(), yf[p])
    assert torch.equal(dc.cnt, base.cnt) and torch.equal(dc.use, base.use)
    if map_store == "host":
        # the device holds two staging slots of positions while a pass
        # walks the pairs, and none between passes
        assert isinstance(dc.xf, list) and dc.maps.slots is None
        for _p, x, _y in dc.maps.walk([0]):
            assert dc.maps.slots.shape == (2, 2, SIZE, SIZE) and x.dtype == dc.xf[0].dtype
        assert dc.maps.slots is None
    p = _t(np.random.default_rng(36).normal(scale=0.01, size=3 * dc.np_each))
    want = base.value_and_grad(p)
    got = dc.value_and_grad(p)
    _close(got, want, 1e-14)
    np.testing.assert_allclose(dc.cost(p.numpy()), float(got[0]), rtol=1e-14)
    e_p, g_p = dc.value_and_grad(p, plain=True)
    np.testing.assert_allclose(float(e_p), float(got[0]), rtol=1e-12)
    np.testing.assert_allclose(g_p.numpy(), got[1].numpy(), rtol=1e-9, atol=1e-12)


def test_host_route_streams_each_pair_once_a_pass():
    """The host route uploads every pair once for the hit counts, once for
    each forward pass and once, in reverse, for the backward."""
    imgs, gains, kw = _case("gain")
    prob = _port_problem(imgs, gains, **kw)
    xf = [m.numpy() for m in prob.device_cost.xf]
    yf = [m.numpy() for m in prob.device_cost.yf]
    dc = _cost(prob, xf, yf, map_store="host")
    P = len(dc.pairs)
    assert dc.maps.uploads == P
    p = _t(np.zeros(3 * dc.np_each))
    dc.value_and_grad(p)
    assert dc.maps.uploads == 3 * P and dc.maps.slots is None
    with torch.no_grad():
        dc(p)
    assert dc.maps.uploads == 4 * P


def test_plain_pair_at_float32_positions_is_the_widened_pair():
    """Float32 positions give the plain pair's f64 results at the same
    positions converted to float64, bit for bit, through both dispatchers
    and BilinearGather's gradient."""
    img, gain, xf, yf, v, _nan = _points(7)
    x32, y32 = _t(xf).float(), _t(yf).float()
    x64, y64 = x32.double(), y32.double()
    for g in (None, _t(gain)):
        a = bilinear.bilinear_gather_plain(_t(img), x32, y32, g)
        assert a.dtype == torch.float64
        assert torch.equal(a, bilinear.bilinear_gather_plain(_t(img), x64, y64, g))
        assert torch.equal(bilinear.bilinear_gather(_t(img), x32, y32, g), a)
        b = bilinear.bilinear_scatter_adjoint_plain(_t(v), x32, y32, img.shape, g)
        assert torch.equal(b, bilinear.bilinear_scatter_adjoint_plain(_t(v), x64, y64,
                                                                      img.shape, g))
        assert torch.equal(bilinear.bilinear_scatter_adjoint(_t(v), x32, y32, img.shape, g), b)
        grads = []
        for x, y in ((x32, y32), (x64, y64)):
            image = _t(img).requires_grad_(True)
            out = bilinear.BilinearGather.apply(image, x, y, g)
            (gi,) = torch.autograd.grad(out, image, _t(v))
            grads.append(gi)
        assert torch.equal(*grads)


def test_bad_storage_keywords_raise():
    imgs, gains, kw = _case("uniform")
    prob = _port_problem(imgs, gains, **kw)
    xf, yf = list(prob.device_cost.xf), list(prob.device_cost.yf)
    with pytest.raises(ValueError, match="map_dtype"):
        _cost(prob, xf, yf, map_dtype="f16")
    with pytest.raises(ValueError, match="map_store"):
        _cost(prob, xf, yf, map_store="disk")
