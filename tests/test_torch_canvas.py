"""
K1's canvas hint on the CPU: the canvas-row segments of a block's points
(interp_cuda.lattice_segments) against a brute-force walk of their flat
indices, the canvas body's tiles (interp_cuda.canvas_tiles) walked as the
kernel walks them (csrc/interp_d5512.cu, interp_canvas_kernel), and the
wing canvas built with the hint against the port without it and against
the JAX package's build_wing_canvas.  The kernel itself runs only on the
card (tests/test_torch_cuda.py); here the plain version ignores the hint.
"""

import numpy as np
import pytest

from pyimcom_tpu.splitpsf import imsubtract as ref_imsub
from pyimcom_tpu_torch.ops import interp_cuda
from pyimcom_tpu_torch.splitpsf import imsubtract
from test_torch_splitpsf import _mosaic


def _walk(idx, width):
    """The segments of `idx` by walking it query by query."""
    out = []
    for q, i in enumerate(int(v) for v in idx):
        r, c = divmod(i, width)
        if out and out[-1][0] == r and out[-1][1] + out[-1][3] == c:
            out[-1][3] += 1
        else:
            out.append([r, c, q, 1])
    return np.asarray(out, np.int64).reshape(-1, 4)


def _footprint(A, roll, scale, shift, side):
    """Flat indices of the points of an A x A canvas whose affine image
    (rolled by `roll` degrees, scaled, shifted) falls in a side x side
    block, as CanvasGeometry.on_block's inside rule picks them."""
    th = np.deg2rad(roll)
    gy, gx = np.mgrid[0:A, 0:A].astype(np.float64)
    u, w = gx - A / 2, gy - A / 2
    xb = scale * (np.cos(th) * u - np.sin(th) * w) + shift[0]
    yb = scale * (np.sin(th) * u + np.cos(th) * w) + shift[1]
    inside = (xb > -5.5) & (xb < side + 4.5) & (yb > -5.5) & (yb < side + 4.5)
    return np.flatnonzero(inside), xb.ravel(), yb.ravel()


def _kernel_walk(hint, nq):
    """The queries each tile's points find, as the kernel finds them: point
    (r, c) of a tile (r below 32, c below its columns, at most 64) takes the
    query of the first of its row's segments that holds column c.  Returns
    how many times each query was found."""
    seg, tiles = hint.segments.astype(np.int64), hint.tiles.astype(np.int64)
    found = np.zeros(nq, np.int64)
    for s0, ns, row0, c0, ncols in tiles:
        assert 0 < ns <= interp_cuda.CANVAS_TILE_SEGS
        assert 0 < ncols <= interp_cuda.CANVAS_TILE_COLS
        ts = seg[s0:s0 + ns]
        assert np.all((ts[:, 0] >= row0) & (ts[:, 0] < row0 + interp_cuda.CANVAS_TILE_ROWS))
        hit = 0
        for r in range(interp_cuda.CANVAS_TILE_ROWS):
            for s in ts[ts[:, 0] == row0 + r]:
                cols = np.arange(max(s[1], c0), min(s[1] + s[3], c0 + ncols))
                found[s[2] + cols - s[1]] += 1
                hit += cols.size
        assert hit > 0                                  # no tile without a query
    return found


@pytest.mark.parametrize("roll", [0, 30, 45, 90])
def test_segments_and_tiles_against_a_walk(roll):
    """Seeded footprints at four rolls, one running over the canvas edges:
    the segments equal the walk's, one a row where the footprint is convex,
    and the tiles find every query exactly once."""
    rng = np.random.default_rng(100 + roll)
    A, side = 131, 90
    for shift in ([side / 2, side / 2], [rng.uniform(-40, 0), rng.uniform(90, 130)]):
        idx, _x, _y = _footprint(A, roll, rng.uniform(0.9, 1.0), shift, side)
        assert idx.size > 100
        seg = interp_cuda.lattice_segments(idx, A)
        assert seg.dtype == np.int32
        np.testing.assert_array_equal(seg, _walk(idx, A))
        assert len(np.unique(seg[:, 0])) == len(seg)      # convex: a row, a segment
        hint = interp_cuda.canvas_segments(idx, A)
        np.testing.assert_array_equal(hint.segments, seg)
        np.testing.assert_array_equal(_kernel_walk(hint, idx.size), 1)
        # the half-warps run along the lattice direction nearer the image's x
        assert not hint.transpose
        if roll != 45:                                    # 45: a tie either way
            assert interp_cuda.canvas_segments(idx, A, _x[idx],
                                               _y[idx]).transpose == (roll == 90)


def test_sparse_lattices_take_smaller_tiles():
    """Points further apart make a tile's window larger: the planner halves
    the tile's columns, then its rows, until the window of one at the worst
    roll fits the kernel's budget, and every query is still found once."""
    assert interp_cuda.canvas_shape(0.94) == (32, 32)
    assert interp_cuda.canvas_shape(3.0) == (16, 8)
    A = 150
    idx, x, y = _footprint(A, 30, 3.0, [200.0, 200.0], 400)
    hint = interp_cuda.canvas_segments(idx, A, x[idx], y[idx])
    assert abs(hint.step - 3.0) < 1e-9 and set(hint.tiles[:, 4]) == {8}
    assert np.diff(np.unique(hint.tiles[:, 2])).min() == 16
    np.testing.assert_array_equal(_kernel_walk(hint, idx.size), 1)


def test_a_row_split_in_two_and_many_segments_a_tile(monkeypatch):
    """A footprint with a hole puts two segments in its rows; with tiles of
    at most 3 segments the bands are halved down to one row and a row's
    segments cut into groups, and every query is still found once."""
    A = 64
    mask = np.zeros((A, A), bool)
    mask[5:40, 3:50] = True
    mask[10:30, 20:25] = False                            # two segments a row
    mask[45, ::3] = True                                  # a row of many short runs
    idx = np.flatnonzero(mask)
    seg = interp_cuda.lattice_segments(idx, A)
    np.testing.assert_array_equal(seg, _walk(idx, A))
    assert np.sum(seg[:, 0] == 15) == 2 and np.sum(seg[:, 0] == 45) == 22
    np.testing.assert_array_equal(_kernel_walk(interp_cuda.canvas_segments(idx, A), idx.size), 1)
    monkeypatch.setattr(interp_cuda, "CANVAS_TILE_SEGS", 3)
    hint = interp_cuda.canvas_segments(idx, A)
    assert hint.tiles[:, 1].max() <= 3
    np.testing.assert_array_equal(_kernel_walk(hint, idx.size), 1)


def test_empty_block_and_bad_segments():
    """No point: no segment and no tile; the wrapper's check refuses a
    table that does not lay out the queries once."""
    hint = interp_cuda.canvas_segments(np.zeros(0, np.int64), 50)
    assert hint.segments.shape == (0, 4) and hint.tiles.shape == (0, 5)
    with pytest.raises(ValueError):
        interp_cuda.lattice_segments(np.array([3, 2]), 50)
    hint = interp_cuda.canvas_segments(np.arange(10, 30), 50)
    interp_cuda._check_segments(hint, 20)
    for nq in (19, 21):
        with pytest.raises(ValueError):
            interp_cuda._check_segments(hint, nq)


def _canvas_case(layer=1):
    """The wing canvas of a 48^2 exposure under a 2x2 mosaic of smooth
    random blocks at oversampling 3, as subtract_wings_blockwise makes it."""
    cfg, bwcs, ewcs = _mosaic(48, 80, 5, 1)
    rng = np.random.default_rng(5)
    N = cfg.NsideP
    yy, xx = np.mgrid[0:N, 0:N]
    blocks = {}
    for key in bwcs:
        data = np.zeros((1, 2, N, N))
        for lay in range(2):
            for _ in range(4):
                x0, y0, s = rng.uniform(0, N), rng.uniform(0, N), rng.uniform(3, 9)
                data[0, lay] += rng.uniform(1, 50) * np.exp(
                    -0.5 * ((xx - x0) ** 2 + (yy - y0) ** 2) / s ** 2)
        blocks[key] = data
    ov, I_pad = 3, 2
    A = ov * (48 + 2 * I_pad)
    x_canvas = np.linspace(-I_pad - 0.5 + 0.5 / ov, 48 + I_pad - 0.5 - 0.5 / ov, A)
    return (ewcs, x_canvas, lambda ix, iy: (blocks[(ix, iy)], bwcs[(ix, iy)]),
            cfg.n2 * cfg.postage_pad, layer)


def test_wing_canvas_with_the_hint(monkeypatch):
    """build_wing_canvas hands each block's segments to K1 (the geometry's
    own, equal to lattice_segments of its indices); the canvas equals the
    port's without the hint bit for bit and the JAX package's within 1e-12
    of its maximum (both float64; the float32 cubes of
    subtract_wings_blockwise are held at 2 float32 spacings in
    test_torch_splitpsf.py)."""
    ewcs, x_canvas, reader, overlap, layer = _canvas_case()
    geo = imsubtract.CanvasGeometry(ewcs, x_canvas)
    seen = []
    orig = imsubtract._interp_scattered

    def spy(image2d, qx, qy, segments=None):
        seen.append(segments)
        return orig(image2d, qx, qy, segments)

    monkeypatch.setattr(imsubtract, "_interp_scattered", spy)
    got = imsubtract.build_wing_canvas(geo, reader, 2, overlap, layer, "cpu").numpy()
    assert len(seen) == 4 and all(s is not None for s in seen)
    for key, s in zip([(ix, iy) for iy in range(2) for ix in range(2)], seen):
        idx = [v for k, v in geo._blocks.items() if k[0] == key][0][0]
        np.testing.assert_array_equal(s.segments, interp_cuda.lattice_segments(idx, geo.A))
        np.testing.assert_array_equal(_kernel_walk(s, idx.size), 1)
    monkeypatch.setattr(imsubtract, "_interp_scattered",
                        lambda image2d, qx, qy, segments=None: orig(image2d, qx, qy))
    plain = imsubtract.build_wing_canvas(geo, reader, 2, overlap, layer, "cpu").numpy()
    np.testing.assert_array_equal(got, plain)
    want = ref_imsub.build_wing_canvas(ewcs, reader, 2, overlap, x_canvas, layer)
    assert want.dtype == np.float64
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
