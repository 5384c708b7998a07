"""pyimcom_tpu_torch.ops.assemble against the JAX package's assembly kernels.

Identical seeded inputs go through both packages on the CPU in float64.
Sweep values agree to 1e-12 (two summation orders, and the reference's
hi/lo table split reconstructs the f64 positions only to the ulp); the
placements (constant addend, A assembly) to 1e-14; the solve + coadd maps to
1e-6 of their scale (float32 output rounding), and U/C to 1e-12 absolute.
The acceptance distances agree to 1e-15 relative (torch's and NumPy's
hypot differ in the last ulp) and the relevance mask exactly.

K2's host side -- its thread-block tiles, the output lattice its B mode
assumes (checked where the tiles are made), and the uniqueness of the destinations that makes its result
independent of the order of its adds -- is checked on the plan of the bench
block's first 2x2 group.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyimcom_tpu.ops import assemble as ref
from pyimcom_tpu_torch.convert import from_numpy
from pyimcom_tpu_torch.ops import assemble, interp, interp_cuda
from k2_layout_torch import b_layout_bytes

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
    # the B rows' i2 entries are an output grid: a 5 x 5 integer lattice
    p = np.arange(m)
    xt[300:300 + m], yt[300:300 + m] = 10.0 + p % 5, 11.0 + p // 5
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
                pmeta=pmeta, bmeta=bmeta, bucket=bucket, m=m, n2f=5, n_pad=n_pad,
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
        _t(interp_cuda.sweep_tiles(c["im_p"], 0)), c["inv_scale"],
        c["off_grid"]).numpy()
    assert interp_cuda.launches["sweep_d5512_scatter.pool"] == 0   # CPU: plain
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
        _t(interp_cuda.sweep_tiles(c["im_b"], 1, c["xt"], c["yt"], c["n2f"])),
        c["inv_scale"], c["off_grid"], c["n_pad"], c["n2f"]).numpy()
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


def _solve_case(nv=1):
    rng = np.random.default_rng(2)
    S, n, m, n_out, nfr, nimg = 2, 96, 25, 1, 2, 3
    A = np.zeros((S, n, n))
    for s in range(S):
        X = rng.standard_normal((n, 40))
        A[s] = X @ X.T / 40 + 1e-3 * np.eye(n)
    B = rng.standard_normal((S, n_out, m, n)) * 0.3
    C = np.array([1.5])
    kC = np.array([5e-4, 1e-3, 2e-3][:nv])
    data = rng.standard_normal((S, nfr, n)).astype(np.float32)
    onehot = np.zeros((S, n, nimg), np.float32)
    for s in range(S):
        onehot[s, np.arange(n), rng.integers(0, nimg, n)] = 1.0
    fade = rng.uniform(0.5, 1.0, m)
    rel = rng.random((S, m, n)) < 0.7
    return A, B, C, kC, data, onehot, fade, rel


def _compare_maps(got, want):
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        g = got[k].numpy().astype(np.float64)
        assert g.shape == w.shape, k
        if k == "UC":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
        else:
            scale = max(np.abs(w).max(), 1e-30)
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * scale, err_msg=k)


def test_solve_finalize_batch_matches_reference():
    """Monolithic single-kappa solve + coadd on identical A and -B/2."""
    A, B, C, kC, data, onehot, fade, _rel = _solve_case()
    S = A.shape[0]
    want = ref.solve_finalize_batch(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(C), jnp.asarray(kC),
        jnp.asarray(data), jnp.asarray(onehot), jnp.asarray(fade),
        jnp.zeros((S, 1, 1), bool), 1e-6, 0.5, 1e-3, 25, "monolithic")
    got = assemble.solve_finalize_batch(
        _t(A), _t(B), _t(C), _t(kC), _t(data), _t(onehot), _t(fade),
        _t(np.zeros((S, 1, 1), bool)), 1e-6, 0.5, 1e-3, 25)
    _compare_maps(got, want)


@pytest.mark.parametrize("solver, nv, exact_UC", [("monolithic", 3, True),
                                                  ("iterative", 1, False),
                                                  ("iterative", 3, True)],
                         ids=["multi-kappa", "iterative", "iterative-multi-kappa"])
def test_solve_finalize_solvers_match_reference(solver, nv, exact_UC):
    """The multi-kappa Cholesky and the Iterative dispatch (with its U/C and
    Sigma clamp at 1e-32) against the reference's solve_finalize_batch; 8
    CG iterations keep finite-precision CG out of its chaotic regime (see
    test_torch_iterative.py)."""
    A, B, C, kC, data, onehot, fade, rel = _solve_case(nv)
    args = (1e-6, 0.5, 1e-3, 25, solver, exact_UC, 8)
    want = ref.solve_finalize_batch(*(jnp.asarray(a) for a in
                                      (A, B, C, kC, data, onehot, fade, rel)), *args)
    got = assemble.solve_finalize_batch(*_t([A, B, C, kC, data, onehot, fade, rel]),
                                        *args)
    _compare_maps(got, want)


def test_relevance_mask_matches_reference():
    """Batched distances and the acceptance mask against the reference's
    relevance_mask per stamp, padded slots at the 1e6 sentinel."""
    rng = np.random.default_rng(4)
    S, m, n_pad, n = 2, 30, 50, 41
    out_x, out_y = rng.uniform(0, 20, (2, S, m))
    in_x = np.full((S, n_pad), 1e6)
    in_y = np.full((S, n_pad), 1e6)
    in_x[:, :n], in_y[:, :n] = rng.uniform(-5, 25, (2, S, n))
    got = assemble.relevance_mask(*_t([out_x, out_y, in_x, in_y]), 4.0).numpy()
    dist = assemble.pixel_distances(*_t([out_x, out_y, in_x, in_y])).numpy()
    for s in range(S):
        want = np.asarray(ref.relevance_mask(*(jnp.asarray(a[s]) for a in
                                               (out_x, out_y, in_x, in_y)), 4.0))
        np.testing.assert_array_equal(got[s], want)
        np.testing.assert_allclose(dist[s, :, :n], np.hypot(
            out_y[s][:, None] - in_y[s][None, :n], out_x[s][:, None] - in_x[s][None, :n]),
            rtol=1e-15, atol=0)
    assert got.any() and not got[:, :, n:].any()


# --------------------------------------------------------------------------
# K2's host side on a real plan
# --------------------------------------------------------------------------

def _sweep_by_rows(dst, combined, xt, yt, ks, imeta, dmeta, inv_scale, off_grid,
                   mode, n_pad=0, m=0):
    """The sweep as the rows alone define it, query j < nval of each row at
    f = off + j (the plain K2 before it took tiles): the yardstick for the
    tiles."""
    ks, imeta, dmeta = ks.long(), imeta.long(), dmeta.long()
    bucket = int(imeta[:, 4].max())
    j = torch.arange(bucket)[None, :]
    if mode == 0:
        g = dmeta[:, 3:4] + j
        w2d = dmeta[:, 1:2].clamp(min=1)
        d = dmeta[:, 0:1] + (g // w2d) * dmeta[:, 2:3] + g % w2d
        ok = j < dmeta[:, 4:5]
    else:
        g = dmeta[:, 2:3] + j
        d = dmeta[:, 0:1] + (g % m) * n_pad + dmeta[:, 1:2] + g // m
        ok = j < dmeta[:, 3:4]
    f = imeta[:, 3:4] + j
    w2 = imeta[:, 2:3].clamp(min=1)
    i1, i2 = imeta[:, 0:1] + f // w2, imeta[:, 1:2] + f % w2
    k = ks[:, None].expand_as(f)
    ok &= (j < imeta[:, 4:5]) & (d >= 0) & (d < dst.shape[0])
    i1, i2, k, d = (t[ok] for t in (i1, i2, k, d))
    qx = (xt[i1] - xt[i2]) * inv_scale + off_grid
    qy = (yt[i1] - yt[i2]) * inv_scale + off_grid
    return dst.index_add_(0, d, interp.interp2d_stack(combined, qx, qy, k))


def _destinations(imeta, dmeta, mode, n_pad=0, m=0, chunk=128):
    """Every destination of every query of the rows, as int64."""
    out = []
    for r0 in range(0, len(imeta), chunk):
        im, dm = imeta[r0:r0 + chunk].astype(np.int64), dmeta[r0:r0 + chunk].astype(np.int64)
        j = np.arange(int(im[:, 4].max()))[None, :]
        ok = (j < im[:, 4:5]) & (j < dm[:, -1:])
        if mode == 0:
            g = dm[:, 3:4] + j
            d = dm[:, 0:1] + (g // dm[:, 1:2]) * dm[:, 2:3] + g % dm[:, 1:2]
        else:
            g = dm[:, 2:3] + j
            d = dm[:, 0:1] + (g % m) * n_pad + dm[:, 1:2] + g // m
        out.append(d[ok])
    return np.concatenate(out)


@pytest.fixture(scope="module")
def bench_plan(tmp_path_factory):
    """The sweep plan of the first 2x2 group of the bench block
    (BASELINE.json configs[0], the survey of chip_smoke.py's bench block).
    The plan depends on the geometry alone, so the survey carries only its
    science layer."""
    from survey_fixture_torch import build_survey

    from pyimcom_tpu_torch.coadd import Block
    from pyimcom_tpu_torch.config import Config
    from pyimcom_tpu_torch.psfgrp import INTERP_PAD

    class Planned(Exception):
        pass

    class FirstPlan(Block):
        def _plan_group(self, infos, n_pad):
            plan = super()._plan_group(infos, n_pad)
            raise Planned(dict(plan, n_pad=n_pad, S=len(infos), n2f=self.cfg.n2f,
                               n_out=self.cfg.n_out, inv_scale=1.0 / self.geom.dscale,
                               off_grid=self.geom.nc_ovl + INTERP_PAD))

    cfg = build_survey(tmp_path_factory.mktemp("bench"), n_obs=8, extrainput=[])
    with pytest.raises(Planned) as got:
        FirstPlan(cfg=Config(cfg), this_sub=1, device="cpu")
    plan = got.value.args[0]
    plan["rows"] = {mode: rest for mode, *rest in plan["sweep_rows"]}
    assert sorted(plan["rows"]) == [0, 1]
    return plan


def test_bench_plan_destinations_are_unique(bench_plan):
    """No two queries of a group land on one pool or -B/2 entry, so K2's
    result does not depend on the order of its adds (a plain add would do;
    the kernel keeps its atomics for speed, csrc/interp_d5512.cu)."""
    p = bench_plan
    m = p["n2f"] ** 2
    sizes = {0: p["pool_size"], 1: p["S"] * p["n_out"] * m * p["n_pad"]}
    for mode, (ks, imeta, dmeta, tiles) in p["rows"].items():
        d = _destinations(imeta, dmeta, mode, p["n_pad"], m)
        assert len(d) == int(imeta[:, 4].sum()) > 0
        assert d.min() >= 0 and d.max() < sizes[mode]
        d.sort()
        assert np.all(d[1:] != d[:-1]), f"mode {mode}: a destination receives two queries"


def test_bench_plan_tiles_cover_every_query_once(bench_plan):
    """Over all rows of the group, each mode's tiles hold as many queries as
    the rows; that they hold each query once is checked value by value in
    test_bench_plan_tiles_match_rows."""
    for mode, (ks, imeta, dmeta, tiles) in bench_plan["rows"].items():
        im = imeta.astype(np.int64)[tiles[:, 0]]
        t = tiles.astype(np.int64)
        # queries of tile i1 entry u: v in [v0, v0 + nv) with off <= u w2 + v < off + nval
        u = t[:, 1:2] + np.arange(int(t[:, 3].max()))[None, :]
        live = u < t[:, 1:2] + t[:, 3:4]
        lo = np.maximum(t[:, 2:3], im[:, 3:4] - u * im[:, 2:3])
        hi = np.minimum(t[:, 2:3] + t[:, 4:5], im[:, 3:4] + im[:, 4:5] - u * im[:, 2:3])
        assert int((np.maximum(hi - lo, 0) * live).sum()) == int(imeta[:, 4].sum())
        if mode == 0:
            assert (t[:, 3] * t[:, 4]).max() <= interp_cuda.TILE_QUERIES
        else:
            # runs of at most B_RUN i1 over the whole lattice
            assert np.all((t[:, 3] >= 1) & (t[:, 3] <= interp_cuda.B_RUN))
            assert np.all(t[:, 2] == 0) and np.all(t[:, 4] == im[:, 2])


@pytest.mark.parametrize("mode", [0, 1], ids=["pool", "B"])
def test_bench_plan_tiles_match_rows(bench_plan, mode):
    """The tiles fed to the plain K2 give the same pool / -B/2 as the rows
    alone (every 25th row of the group, seeded overlap images of the real
    size) to 1e-15 of scale."""
    p = bench_plan
    ks, imeta, dmeta, _tiles = p["rows"][mode]
    sub = np.arange(0, len(ks), 25)
    used, kmap = np.unique(ks[sub], return_inverse=True)
    ks, imeta, dmeta = kmap.astype(np.int32), imeta[sub], dmeta[sub]
    ny, nx = p["stacks"][0].shape[1:]
    combined = np.random.default_rng(8).normal(size=(len(used), ny, nx))
    m = p["n2f"] ** 2
    size = p["pool_size"] if mode == 0 else p["S"] * p["n_out"] * m * p["n_pad"]
    xt, yt = _t(p["xt"]), _t(p["yt"])
    want = _sweep_by_rows(torch.zeros(size, dtype=torch.float64), _t(combined), xt, yt,
                          _t(ks), _t(imeta), _t(dmeta), p["inv_scale"], p["off_grid"],
                          mode, p["n_pad"], m)
    got = interp_cuda.sweep_scatter_plain(
        torch.zeros(size, dtype=torch.float64), _t(combined), xt, yt, _t(ks), _t(imeta),
        _t(dmeta), _t(interp_cuda.sweep_tiles(imeta, mode, p["xt"], p["yt"], p["n2f"])),
        p["inv_scale"], p["off_grid"], mode, p["n_pad"], p["n2f"])
    assert int((want != 0).sum()) > 0.5 * int(imeta[:, 4].sum())
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-15 * scale)


def test_bench_plan_output_grids_are_lattices(bench_plan):
    """The B rows' output coordinates are the exact integer lattice that K2's
    B mode computes them from.  Moving one output pixel by 1e-9, a wrong
    n2f, a w2 other than n2f**2 or a lattice that leaves the tables makes
    the check, and with it the planning of the B tiles, raise."""
    p = bench_plan
    _ks, imeta, _dmeta, tiles = p["rows"][1]
    xt, yt, n2f = p["xt"], p["yt"], p["n2f"]
    interp_cuda.check_output_lattice(xt, yt, imeta, n2f)
    np.testing.assert_array_equal(interp_cuda.sweep_tiles(imeta, 1, xt, yt, n2f), tiles)
    bad = xt.copy()
    bad[int(imeta[0, 1]) + n2f + 3] += 1e-9
    w2 = imeta.copy()
    w2[:, 2] -= 1
    past = imeta.copy()
    past[-1, 1] = len(xt) - n2f
    for args, what in (((bad, yt, imeta, n2f), "lattice"), ((xt, yt, imeta, n2f - 1), "n2f"),
                       ((xt, yt, w2, n2f), "w2"), ((xt, yt, past, n2f), "tables")):
        with pytest.raises(ValueError, match=what):
            interp_cuda.check_output_lattice(*args)
        with pytest.raises(ValueError, match=what):
            interp_cuda.sweep_tiles(args[2], 1, args[0], args[1], args[3])
    with pytest.raises(ValueError, match="tables"):
        interp_cuda.sweep_tiles(imeta, 1)


@pytest.mark.parametrize("mode", [0, 1], ids=["pool", "B"])
def test_sweep_tiles_partition_odd_rows(mode):
    """Tiles of rows with odd offsets, partial i1 entries, narrow and empty
    rectangles hold every query once."""
    rng = np.random.default_rng(11 + mode)
    rows = 40
    n2f = 7
    w2 = np.full(rows, n2f * n2f) if mode else rng.integers(1, 90, rows)
    off = rng.integers(0, 300, rows)
    nval = rng.integers(0, 2000, rows)
    nval[::7] = 0
    imeta = np.stack([np.zeros(rows), np.zeros(rows), w2, off, nval], 1).astype(np.int32)
    lattice = np.arange(n2f * n2f)        # the B rows' output grid at i2_start 0
    tiles = interp_cuda.sweep_tiles(imeta, mode, lattice % n2f, lattice // n2f, n2f)
    seen = []
    for r, u0, v0, nu, nv in tiles.astype(np.int64):
        u, v = np.meshgrid(np.arange(u0, u0 + nu), np.arange(v0, v0 + nv), indexing="ij")
        f = (u * w2[r] + v).ravel()
        f = f[(f >= off[r]) & (f < off[r] + nval[r])]
        assert np.all(v < w2[r])
        seen.append(r * 10 ** 6 + f)
    seen = np.sort(np.concatenate(seen))
    want = np.sort(np.concatenate([r * 10 ** 6 + np.arange(off[r], off[r] + nval[r])
                                   for r in range(rows)]))
    np.testing.assert_array_equal(seen, want)


def _pool_pieces(tile, im, xt, yt, inv_scale, off_grid, ny, nx, kern,
                 slot=interp_cuda.POOL_SLOT_DOUBLES, cap=1024, umax=64):
    """The pieces [(u_a, u_b, window doubles or None)] of one pool tile as
    K2 cuts them (csrc/interp_d5512.cu, pool_next): at most `cap` queries
    and `umax` i1 entries, halved in u until the window of the piece's table
    extremes, clipped to the family's valid range, fits `slot` (None: a
    single i1 that does not fit, read from L2 with the rest of the tile)."""
    taps, lo, hi = interp.KERNEL_FAMILIES[kern][2:5]
    row, u0, v0, nu, nv = (int(v) for v in tile)
    i1s, i2s = int(im[row, 0]), int(im[row, 1])
    x2, y2 = xt[i2s + v0:i2s + v0 + nv], yt[i2s + v0:i2s + v0 + nv]
    out, ua, end = [], u0, u0 + nu
    while ua < end:
        ub = min(end, ua + min(umax, max(cap // nv, 1)))
        while True:
            x1, y1 = xt[i1s + ua:i1s + ub], yt[i1s + ua:i1s + ub]
            xs = (np.array([x1.min() - x2.max(), x1.max() - x2.min()]) * inv_scale + off_grid)
            ys = (np.array([y1.min() - y2.max(), y1.max() - y2.min()]) * inv_scale + off_grid)
            fx = max(np.floor(xs.min()), lo), min(np.floor(xs.max()), nx - hi - 1)
            fy = max(np.floor(ys.min()), lo), min(np.floor(ys.max()), ny - hi - 1)
            if fx[0] > fx[1] or fy[0] > fy[1]:
                win = 0                     # no query of the piece on the grid
                break
            wx, wy = int(fx[1] - fx[0]) + taps, int(fy[1] - fy[0]) + taps
            win = 3 + wy * (wx + 2)         # a spare double a row, nx's parity, shift
            if win <= slot:
                break
            if ub - ua == 1:
                win, ub = None, end
                break
            ub = ua + (ub - ua + 1) // 2
        out.append((ua, ub, win))
        ua = ub
    return out


def test_bench_plan_pool_windows_fit_a_slot(bench_plan):
    """Every piece of every pool tile of the group stages its window in one
    of K2's two slots (none is read from L2), and few tiles are cut: the
    windows of the planner's tiles fit the budget the kernel assumes.  The
    tiles that are one piece (their first piece, of at most 64 i1 and 1024
    queries, holds the whole tile and its window fits) are found at once;
    the others are cut as the kernel cuts them."""
    p = bench_plan
    _ks, imeta, _dmeta, tiles = p["rows"][0]
    ny, nx = p["stacks"][0].shape[1:]
    xt, yt, s, off = p["xt"], p["yt"], p["inv_scale"], p["off_grid"]
    taps, lo, hi = interp.KERNEL_FAMILIES["D5512"][2:5]
    t = tiles.astype(np.int64)
    row, u0, v0, nu, nv = t.T
    i1, i2 = imeta[row, 0].astype(np.int64) + u0, imeta[row, 1].astype(np.int64) + v0

    def extremes(tab, start, n):
        # min and max of tab[start:start + n] for every tile (n <= 64)
        idx = start[:, None] + np.arange(64)
        a = np.where(np.arange(64) < n[:, None], tab[np.minimum(idx, len(tab) - 1)], np.nan)
        return np.nanmin(a, 1), np.nanmax(a, 1)

    whole = nu <= np.minimum(64, np.maximum(1024 // nv, 1))
    (x1a, x1b), (y1a, y1b) = extremes(xt, i1, np.minimum(nu, 64)), extremes(yt, i1,
                                                                           np.minimum(nu, 64))
    (x2a, x2b), (y2a, y2b) = extremes(xt, i2, nv), extremes(yt, i2, nv)
    fxl = np.maximum(np.floor((x1a - x2b) * s + off), lo)
    fxh = np.minimum(np.floor((x1b - x2a) * s + off), nx - hi - 1)
    fyl = np.maximum(np.floor((y1a - y2b) * s + off), lo)
    fyh = np.minimum(np.floor((y1b - y2a) * s + off), ny - hi - 1)
    win = np.where((fxl > fxh) | (fyl > fyh), 0,
                   3 + (fyh - fyl + taps) * (fxh - fxl + taps + 2))
    one_piece = whole & (win <= interp_cuda.POOL_SLOT_DOUBLES)
    cut = 0
    for t_ in tiles[~one_piece]:
        pieces = _pool_pieces(t_, imeta, xt, yt, s, off, ny, nx, "D5512")
        assert all(w is not None and w <= interp_cuda.POOL_SLOT_DOUBLES for *_, w in pieces)
        assert pieces[0][0] == t_[1] and pieces[-1][1] == t_[1] + t_[3]
        cut += len(pieces) > 1
    assert cut <= 0.02 * len(tiles), (cut, len(tiles))
    # the fast path agrees with the kernel's cut on a few of its tiles
    for t_ in tiles[one_piece][:: max(1, int(one_piece.sum()) // 20)]:
        assert len(_pool_pieces(t_, imeta, xt, yt, s, off, ny, nx, "D5512")) == 1


@pytest.mark.parametrize("kern", ["D5512", "G4460"])
def test_bench_plan_b_windows_fit(bench_plan, kern):
    """The floors of each i1's output lattice span at most b_window samples
    on either axis, taps included: the window K2's B mode sizes its shared
    memory for (interp_cuda.b_window) holds every i1 of the group."""
    p = bench_plan
    _ks, imeta, _dmeta, tiles = p["rows"][1]
    n2f, s, off = p["n2f"], p["inv_scale"], p["off_grid"]
    taps = interp.KERNEL_FAMILIES[kern][2]
    wmax = interp_cuda.b_window(n2f, s, kern)
    c = np.arange(n2f)
    for r, u0, _v0, nu, _nv in tiles.astype(np.int64):
        i1 = imeta[r, 0] + np.arange(u0, u0 + nu)
        i2 = imeta[r, 1]
        fx = np.floor((p["xt"][i1][:, None] - (p["xt"][i2] + c)) * s + off)
        fy = np.floor((p["yt"][i1][:, None] - (p["yt"][i2] + c)) * s + off)
        assert np.all(np.ptp(fx, axis=1) + taps <= wmax)
        assert np.all(np.ptp(fy, axis=1) + taps <= wmax)


def test_k2_source_defaults_match_the_planner():
    """The kernel source's slot size and B run length are the planner's."""
    from pathlib import Path

    src = (Path(interp_cuda.__file__).parent.parent / "csrc" / "interp_d5512.cu").read_text()
    assert f"constexpr int kPoolSlot = {interp_cuda.POOL_SLOT_DOUBLES};" in src
    assert f"constexpr int kBRun = {interp_cuda.B_RUN};" in src


def test_b_runs_cross_row_ends_as_one_tile_an_i1():
    """A B rectangle cut into rows in the middle of an i1 (as the coadd cuts
    it at CHUNK queries): its runs hold every query once, and the plain K2
    on the runs equals the plain K2 on one tile an i1 (the tiles before
    runs) bit for bit."""
    rng = np.random.default_rng(14)
    n2f, n_pad = 5, 40
    m = n2f * n2f
    L = 300
    xt, yt = rng.uniform(20, 30, L), rng.uniform(20, 30, L)
    p = np.arange(m)
    xt[250:250 + m], yt[250:250 + m] = 3.0 + p % n2f, 4.0 + p // n2f
    w1, chunk = 23, 2 * m + 7                 # rows end mid-i1
    nq = w1 * m
    offs = np.arange(0, nq, chunk)
    nval = np.minimum(chunk, nq - offs)
    rows = len(offs)
    imeta = np.stack([np.full(rows, 10), np.full(rows, 250), np.full(rows, m), offs, nval],
                     1).astype(np.int32)
    dmeta = np.stack([np.zeros(rows), np.full(rows, 3), offs, nval], 1).astype(np.int32)
    ks = rng.integers(0, 3, rows).astype(np.int32)
    runs = interp_cuda.sweep_tiles(imeta, 1, xt, yt, n2f)
    assert np.all(runs[:, 3] <= interp_cuda.B_RUN) and (runs[:, 3] > 1).any()
    seen = []
    for r, u0, v0, nu, nv in runs.astype(np.int64):
        f = (np.arange(u0, u0 + nu)[:, None] * m + np.arange(v0, v0 + nv)).ravel()
        seen.append(f[(f >= offs[r]) & (f < offs[r] + nval[r])])
    np.testing.assert_array_equal(np.sort(np.concatenate(seen)), np.arange(nq))
    nu = runs[:, 3].astype(np.int64)
    rr = np.repeat(np.arange(len(runs)), nu)
    u = runs[rr, 1] + np.arange(len(rr)) - np.repeat(np.cumsum(nu) - nu, nu)
    one = np.stack([runs[rr, 0], u, np.zeros_like(u), np.ones_like(u),
                    np.full_like(u, m)], 1).astype(np.int32)
    combined = _t(rng.normal(size=(3, 64, 64)))
    args = (combined, _t(xt), _t(yt), _t(ks), _t(imeta), _t(dmeta))
    size = m * n_pad
    got = interp_cuda.sweep_scatter_plain(torch.zeros(size, dtype=torch.float64), *args,
                                          _t(runs), 1.7, 5.0, 1, n_pad, n2f, "G4460")
    want = interp_cuda.sweep_scatter_plain(torch.zeros(size, dtype=torch.float64), *args,
                                           _t(one), 1.7, 5.0, 1, n_pad, n2f, "G4460")
    assert int((want != 0).sum()) > nq // 2
    assert torch.equal(got, want)


@pytest.mark.parametrize("kern", ["D5512", "G4460"])
def test_b_layout_launches_every_lattice_of_the_one_i1_body(kern):
    """Every (n2f, wmax) whose window the one-i1 B body (x and y taps, one
    buffer of horizontal sums, a wmax x wmax window, the floors; 16 bytes
    of static shared memory) fitted in a block's 232448 bytes fits the
    run layouts too: where one i1 with two buffers does not fit, the
    compact layout takes exactly that body's bytes."""
    taps = interp.KERNEL_FAMILIES[kern][2]
    pitch = {"D5512": 10, "G4460": 9}[kern]
    n2f = np.arange(1, 161)[:, None]
    wmax = np.arange(taps + 2, 261)[None, :]
    body = 8 * (2 * n2f * pitch + wmax * n2f + wmax * wmax) + 8 * n2f
    fits = np.argwhere(body + 16 <= 232448)
    compact = 0
    for a, b in fits:
        n, w = int(n2f[a, 0]), int(wmax[0, b])
        got = b_layout_bytes(n, w, taps, pitch)
        assert got <= 232448, (n, w, got)
        if n * (2 * pitch * 8 + 8) + 56 + 32 + 8 * (2 * w * n + (w * (w + 1) + 2 & ~1)) \
                > 232448:
            assert got == int(body[a, b]), (n, w)
            compact += 1
    assert compact > 100
    # the lattices of the survey's defaults beyond the run layouts: n2f 54 at
    # 2.13 samples an output pixel (oversampling 6) and n2f 44 at 2.84 (8)
    for n, s in ((54, 2.13), (44, 2.84)):
        w = interp_cuda.b_window(n, s, kern)
        assert b_layout_bytes(n, w, taps, pitch) == \
            8 * (2 * n * pitch + w * n + w * w) + 8 * n


def test_b_runs_shorten_to_fill_the_card():
    """With min_tiles, B runs are shortened until the launch has that many
    tiles (one i1 a tile at the least), and every query still falls in
    exactly one tile."""
    n2f = 5
    m = n2f * n2f
    L = 200
    rng = np.random.default_rng(7)
    xt, yt = rng.uniform(0, 9, L), rng.uniform(0, 9, L)
    xt[150:150 + m], yt[150:150 + m] = 1.0 + np.arange(m) % n2f, 2.0 + np.arange(m) // n2f
    rows = 6
    offs = np.zeros(rows, int)
    nval = np.full(rows, 22 * m)
    imeta = np.stack([np.full(rows, 3), np.full(rows, 150), np.full(rows, m), offs, nval],
                     1).astype(np.int32)
    for min_tiles, want_run in ((0, 8), (18, 8), (19, 7), (60, 2), (200, 1)):
        t = interp_cuda.sweep_tiles(imeta, 1, xt, yt, n2f, min_tiles=min_tiles)
        assert t[:, 3].max() == want_run, (min_tiles, t[:, 3].max())
        assert len(t) >= min(min_tiles, rows * 22)
        seen = np.sort(np.concatenate([r * 10 ** 6 + u0 + np.arange(nu)
                                       for r, u0, _v0, nu, _nv in t.astype(np.int64)]))
        np.testing.assert_array_equal(
            seen, np.sort((np.arange(rows)[:, None] * 10 ** 6 + np.arange(22)).ravel()))
    assert interp_cuda.b_min_tiles("cpu") == 0
