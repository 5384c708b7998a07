"""pyimcom_tpu_torch.ops.assemble against the JAX package's assembly kernels.

Identical seeded inputs go through both packages on the CPU in float64.
Sweep values agree to 1e-12 (two summation orders, and the reference's
hi/lo table split reconstructs the f64 positions only to the ulp); the
placements (constant addend, A assembly) to 1e-14; the solve + coadd maps to
1e-6 of their scale (float32 output rounding), and U/C to 1e-12 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyimcom_tpu.ops import assemble as ref
from pyimcom_tpu_torch.convert import from_numpy
from pyimcom_tpu_torch.ops import assemble, interp_cuda

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _t(a):
    return from_numpy(a, CPU)


@pytest.fixture(scope="module")
def sweep_case():
    """The metadata of tests/test_device_assembly.py::test_sweep_v2_kernels_
    match_v1: one pool rect (w1=9, w2=11, two pieces) and one B rect
    (w1=6, w2=m), kind-segregated, with padded rows."""
    rng = np.random.default_rng(3)
    K, W = 5, 64
    L, m, n_pad = 400, 25, 48
    combined = rng.standard_normal((K, W, W))
    xt = np.pad(rng.uniform(5, 20, L), (0, 300))
    yt = np.pad(rng.uniform(5, 20, L), (0, 300))
    bucket, NB, R = 64, 3, 4
    ks = np.zeros((NB, R), np.int32)
    im_p = np.tile(np.array([0, 0, 1, 0, 0], np.int32), (NB, R, 1))
    im_b = im_p.copy()
    pmeta = np.tile(np.array([0, 1, 1, 0, 0], np.int32), (NB, R, 1))
    bmeta = np.zeros((NB, R, 4), np.int32)
    kg, i1, i2, w1, w2, base, stride = (2, 40, 120, 9, 11, 17, 13)
    rows = [(kg, i1, i2, w2, off, min(bucket, w1 * w2 - off), base, stride, 0)
            for off in range(0, w1 * w2, bucket)]
    rows += [(4, 200, 300, m, off, min(bucket, 6 * m - off), 0, 3, 1)
             for off in range(0, 6 * m, bucket)]
    for j, (kg_, i1_, i2_, w2_, off, nval, a_, b_, kind) in enumerate(rows):
        nb, r = divmod(j, R)
        ks[nb, r] = kg_
        if kind == 0:
            im_p[nb, r] = (i1_, i2_, w2_, off, nval)
            pmeta[nb, r] = (a_, w2_, b_, off, nval)
        else:
            im_b[nb, r] = (i1_, i2_, w2_, off, nval)
            bmeta[nb, r] = (a_, b_, off, nval)
    return dict(combined=combined, xt=xt, yt=yt, ks=ks, im_p=im_p, im_b=im_b,
                pmeta=pmeta, bmeta=bmeta, bucket=bucket, m=m, n_pad=n_pad,
                inv_scale=2.0, off_grid=32.0, P=512)


def test_sweep_pool_matches_reference(sweep_case):
    c = sweep_case
    tabs = [jnp.asarray(t) for t in ref.split_tables(c["xt"], c["yt"])]
    want = np.asarray(ref.sweep_pool_scan(
        jnp.zeros(c["P"]), jnp.asarray(c["combined"]), *tabs,
        jnp.asarray(c["ks"]), jnp.asarray(c["im_p"]), jnp.asarray(c["pmeta"]),
        c["inv_scale"], c["off_grid"], c["bucket"], "D5512"))
    interp_cuda.reset_launch_counts()
    got = assemble.sweep_pool(
        torch.zeros(c["P"], dtype=torch.float64), _t(c["combined"]), _t(c["xt"]),
        _t(c["yt"]), _t(c["ks"]), _t(c["im_p"]), _t(c["pmeta"]),
        c["inv_scale"], c["off_grid"], c["bucket"]).numpy()
    assert interp_cuda.launches["sweep_d5512_scatter"] == 0   # CPU: plain
    assert np.count_nonzero(want) > 50
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_sweep_b_matches_reference(sweep_case):
    c = sweep_case
    nB = c["m"] * c["n_pad"]
    want = np.asarray(ref.sweep_b_scan(
        jnp.zeros(nB), jnp.asarray(c["combined"]), jnp.asarray(c["xt"]),
        jnp.asarray(c["yt"]), jnp.asarray(c["ks"]), jnp.asarray(c["im_b"]),
        jnp.asarray(c["bmeta"]), c["inv_scale"], c["off_grid"], c["bucket"],
        "D5512", c["n_pad"], c["m"]))
    got = assemble.sweep_b(
        torch.zeros(nB, dtype=torch.float64), _t(c["combined"]), _t(c["xt"]),
        _t(c["yt"]), _t(c["ks"]), _t(c["im_b"]), _t(c["bmeta"]),
        c["inv_scale"], c["off_grid"], c["n_pad"], c["m"], c["bucket"]).numpy()
    assert np.count_nonzero(want) > 50
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_scatter_pool_constant_matches_reference():
    rng = np.random.default_rng(4)
    P, bucket = 300, 64
    pool = rng.standard_normal(P)
    meta = np.array([[11, 30, 53, 0, 64], [11, 30, 53, 64, 60],
                     [200, 7, 9, 0, 20], [0, 1, 1, 0, 0]], np.int32)
    consts = np.array([0.25, 0.25, -1.5, 9.0])
    want = np.asarray(ref.scatter_pool_constant(
        jnp.asarray(pool), jnp.asarray(consts), jnp.asarray(meta), bucket))
    got = assemble.scatter_pool_constant(_t(pool), _t(consts), _t(meta),
                                         bucket).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)


@pytest.mark.parametrize("sym", [False, True])
def test_dus_A_assembly_matches_reference(sym):
    """index_select + slice add == the reference's one-hot compaction +
    dynamic-slice add, on a rung-padded pool with unselected rows."""
    rng = np.random.default_rng(7)
    n1s, n2s = 37, 53
    n1r, n2r = 40, 56
    S, n_pad = 3, 64
    base = n1r * n2r
    pool = np.zeros(2 * n1r * n2r)
    blk = np.zeros((n1r, n2r))
    blk[:n1s, :n2s] = rng.standard_normal((n1s, n2s))
    pool[base:] = blk.ravel()
    sel1 = np.full(n1s, -1, np.int32)
    sel1[::2] = np.arange((n1s + 1) // 2)
    sel2 = np.full(n2s, -1, np.int32)
    sel2[-20:] = 10 + np.arange(20)
    selmap = np.full(n1r + n2r + 8, -1, np.int32)
    selmap[:n1s] = sel1
    selmap[n1r:n1r + n2s] = sel2
    diag = rng.standard_normal((S, n_pad))
    uses = np.zeros((4, 7), np.int32)
    uses[1] = (base, 0, n1r, 2, 1, 0, 10)
    NC = n_pad + max(n1r, n2r)

    cv = ref.init_A_canvas(jnp.asarray(diag), n_pad, NC)
    cv = ref.pool_to_A_dus(cv, jnp.asarray(pool), jnp.asarray(uses),
                           jnp.asarray(selmap), n1r, n2r, NC, sym)
    want = np.asarray(ref.canvas_to_A(cv, n_pad))

    cv_t = assemble.init_A_canvas(_t(diag), n_pad, NC)
    assemble.pool_to_A_dus(cv_t, _t(pool), uses, selmap, n1r, n2r, sym)
    got = assemble.canvas_to_A(cv_t, n_pad).numpy()
    assert np.count_nonzero(got) > S * n_pad
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)


def test_solve_finalize_batch_matches_reference():
    """Monolithic single-kappa solve + coadd on identical A and -B/2."""
    rng = np.random.default_rng(2)
    S, n, m, n_out, nfr, nimg = 2, 96, 25, 1, 2, 3
    A = np.zeros((S, n, n))
    for s in range(S):
        X = rng.standard_normal((n, 40))
        A[s] = X @ X.T / 40 + 1e-3 * np.eye(n)
    B = rng.standard_normal((S, n_out, m, n)) * 0.3
    C = np.array([1.5])
    kC = np.array([5e-4])
    data = rng.standard_normal((S, nfr, n)).astype(np.float32)
    onehot = np.zeros((S, n, nimg), np.float32)
    for s in range(S):
        onehot[s, np.arange(n), rng.integers(0, nimg, n)] = 1.0
    fade = rng.uniform(0.5, 1.0, m)
    want = ref.solve_finalize_batch(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(C), jnp.asarray(kC),
        jnp.asarray(data), jnp.asarray(onehot), jnp.asarray(fade),
        jnp.zeros((S, 1, 1), bool), 1e-6, 0.5, 1e-3, 25, "monolithic")
    got = assemble.solve_finalize_batch(
        _t(A), _t(B), _t(C), _t(kC), _t(data), _t(onehot), _t(fade),
        1e-6, 0.5, 25)
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        g = got[k].numpy().astype(np.float64)
        assert g.shape == w.shape, k
        if k == "UC":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
        else:
            scale = max(np.abs(w).max(), 1e-30)
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * scale, err_msg=k)
