"""
Device-resident system-matrix assembly and the batched solve + coadd.

Counterpart of pyimcom_tpu/ops/assemble.py, for the Cholesky block coadd:

1. :func:`sweep_pool` / :func:`sweep_b` -- the fused sweep: every query of
   the group's system-submatrix and -B/2 rectangles is interpolated in an
   overlap stack and added into the submatrix pool or into -B/2.  On a CUDA
   tensor both launch the hand-written kernel K2 (ops/interp_cuda.py); on a
   CPU tensor they run its plain version.  They take the f64 coordinate
   tables directly, so the JAX package's int / f32-hi / f32-lo table split
   and its one-hot window matmuls are gone.
2. :func:`scatter_pool_constant` -- the flat-field penalty addend.
3. :func:`init_A_canvas`, :func:`pool_to_A_dus`, :func:`canvas_to_A` -- A
   assembly: each submatrix use selects its rows and columns with
   ``index_select`` and adds the block at its slot origin.
4. :func:`solve_finalize` / :func:`solve_finalize_batch` -- the f64 solve
   with any of the four LAKERNELs, trapezoid fade, coaddition and per-image
   weight sums; :func:`pixel_distances` / :func:`relevance_mask` give the
   Iterative and Empirical kernels their output-to-input geometry.

Buffers are updated in place (the JAX versions donate and return them);
each function also returns the updated buffer.  Metadata rows keep the
JAX package's layout, row for row.
"""

from __future__ import annotations

import numpy as np
import torch

from ..solvers import cholesky_solve, eigen_solve, empirical_weights, iterative_solve
from . import interp_cuda


def _sweep(dst, combined, xt, yt, ks, imeta, dmeta, tiles, inv_scale, off_grid,
           mode, n_pad=0, n2f=0):
    if combined.is_cuda:
        fn = interp_cuda.sweep_d5512_scatter
    elif combined.device.type == "cpu":
        fn = interp_cuda.sweep_d5512_scatter_plain
    else:
        raise ValueError(f"sweep: unsupported device {combined.device}")
    return fn(dst, combined, xt, yt, ks, imeta, dmeta, tiles, inv_scale, off_grid,
              mode, n_pad, n2f)


def sweep_pool(pool, combined, xt, yt, ks, imeta, pmeta, tiles, inv_scale, off_grid):
    """
    Fused sweep over POOL rectangles (contract of the JAX package's
    ``sweep_pool_scan``): query j of row r compares table entries
    i1 = i1_start + f // w2 and i2 = i2_start + f % w2 (f = off + j, j <
    nval) at ((xt[i1] - xt[i2]) * inv_scale + off_grid, same for y),
    interpolates overlap image ks[r] of `combined`, and adds the value at
    pool[dst_base0 + (f // w2) * stride + f % w2].

    pool (P,) f64, updated in place; combined (K, ny, nx) f64; xt, yt (L,)
    f64; ks (..., ) int32; imeta (..., 5) int32 rows [i1_start, i2_start,
    w2, off, nval]; pmeta (..., 5) int32 rows [dst_base0, w2, stride, off,
    nval]; tiles (T, 5) int32, ``interp_cuda.sweep_tiles(imeta, 0)``.
    """
    return _sweep(pool, combined, xt, yt, ks, imeta, pmeta, tiles, inv_scale,
                  off_grid, 0)


def sweep_b(Bflat, combined, xt, yt, ks, imeta, bmeta, tiles, inv_scale, off_grid,
            n_pad: int, n2f: int):
    """
    Fused sweep over -B/2 rectangles (contract of ``sweep_b_scan``): as
    :func:`sweep_pool` with w2 == m == n2f**2, the value landing at
    Bflat[dst_base + (f % m) * n_pad + col0 + f // m].  The i2 entries of
    every row must be an output grid, an exact n2f x n2f integer lattice:
    the tiles, ``interp_cuda.sweep_tiles(imeta, 1, xt, yt, n2f)``, raise
    otherwise.

    Bflat (S*n_out*m*n_pad,) f64, updated in place; bmeta (..., 4) int32
    rows [dst_base, col0, off, nval].
    """
    return _sweep(Bflat, combined, xt, yt, ks, imeta, bmeta, tiles, inv_scale,
                  off_grid, 1, n_pad, n2f)


def scatter_pool_constant(pool, consts, meta, bucket: int):
    """Add a per-row constant over rectangle regions of the pool (the
    flat-field penalty terms).  consts (R,); meta (R, 5) rows [dst_base0,
    w2, stride, off, nval] as in :func:`sweep_pool`."""
    meta = meta.long()
    j = torch.arange(bucket, device=pool.device)[None, :]
    f = meta[:, 3:4] + j
    w2 = meta[:, 1:2].clamp(min=1)
    dst = meta[:, 0:1] + (f // w2) * meta[:, 2:3] + f % w2
    ok = (j < meta[:, 4:5]) & (dst >= 0) & (dst < pool.shape[0])
    vals = torch.where(ok, consts[:, None].to(pool.dtype), 0.0)
    dst = torch.where(ok, dst, 0)
    return pool.index_add_(0, dst.reshape(-1), vals.reshape(-1))


def init_A_canvas(eye_scales, n_pad: int, NC: int):
    """(S, NC, NC) canvas with `eye_scales` (S, n_pad) on the diagonal of
    its live (n_pad, n_pad) corner (identity on padded slots), zero
    elsewhere."""
    S = eye_scales.shape[0]
    cv = torch.zeros((S, NC, NC), dtype=eye_scales.dtype,
                     device=eye_scales.device)
    i = torch.arange(n_pad, device=eye_scales.device)
    cv[:, i, i] = eye_scales
    return cv


def canvas_to_A(canvas, n_pad: int):
    """The live flat A batch (S*n_pad*n_pad,) of a canvas."""
    return canvas[:, :n_pad, :n_pad].reshape(-1)


def _select(block, dim: int, src: np.ndarray):
    """Rows (dim 0) or columns (dim 1) `src` of a block, as index_select;
    a leading run 0..k-1 is a plain narrow."""
    if len(src) and src[-1] == len(src) - 1:
        return block.narrow(dim, 0, len(src))
    return block.index_select(dim, torch.as_tensor(src, device=block.device))


def pool_to_A_dus(canvas, pool, uses, selmap, n1r: int, n2r: int, sym: bool):
    """
    Place pooled submatrices into the stamp system matrices (contract of
    the JAX package's ``pool_to_A_dus``).

    canvas (S, NC, NC), updated in place; pool (P,) holds each submatrix
    row-major as an (n1r, n2r) tile at `base`.  uses (U, 7) host rows
    [base, m1_off, m2_off, s_idx, valid, dst1, dst2]; selmap (L,) host int
    map of local pixel -> A slot (-1 = unselected).  Row r of the tile goes
    to slot selmap[m1_off + r] (likewise columns); the planner maps the
    selected pixels of an input stamp onto the contiguous slot range that
    starts at dst1 (dst2), in order, so each use is one index_select of the
    selected rows and columns plus one slice add.  `sym` also adds the
    transpose (the off-diagonal block pairs).
    """
    selmap = np.asarray(selmap)
    L = len(selmap) - 1
    r = np.arange(n1r)
    c = np.arange(n2r)
    for base, m1, m2, s_idx, valid, dst1, dst2 in np.asarray(uses).tolist():
        if not valid:
            continue
        t1 = selmap[np.minimum(m1 + r, L)] - dst1
        t2 = selmap[np.minimum(m2 + c, L)] - dst2
        src1 = np.flatnonzero((t1 >= 0) & (t1 < n1r))
        src2 = np.flatnonzero((t2 >= 0) & (t2 < n2r))
        if not (np.array_equal(t1[src1], np.arange(len(src1)))
                and np.array_equal(t2[src2], np.arange(len(src2)))):
            raise ValueError("pool_to_A_dus: selected pixels must map onto a "
                             "contiguous slot range in order")
        sub = pool[base:base + n1r * n2r].view(n1r, n2r)
        blk = _select(_select(sub, 0, src1), 1, src2)
        canvas[s_idx, dst1:dst1 + len(src1), dst2:dst2 + len(src2)] += blk
        if sym:
            canvas[s_idx, dst2:dst2 + len(src2), dst1:dst1 + len(src1)] += blk.T
    return canvas


def pixel_distances(out_x, out_y, in_x, in_y):
    """Output-to-input pixel distances (..., m, n_pad) from output grids
    (..., m) and input coordinates (..., n_pad).  Padded slots sit at the
    1e6 sentinel, outside every acceptance radius."""
    return torch.hypot(out_y[..., :, None] - in_y[..., None, :],
                       out_x[..., :, None] - in_x[..., None, :])


def relevance_mask(out_x, out_y, in_x, in_y, rho):
    """(..., m, n_pad) acceptance mask |out - in| < rho of the Iterative
    kernel (reference lakernel.py:614-620)."""
    return pixel_distances(out_x, out_y, in_x, in_y) < rho


def solve_finalize(A, mBhalf, C, kappaC, data, img_onehot, fade, relevant,
                   ucmin, smax, rtol, n2sq: int, solver: str = "monolithic",
                   exact_UC: bool = True, maxiter: int = 30, dist=None,
                   rho_acc: float = 0.0, no_qlt_ctrl: bool = False):
    """
    Per-stamp f64 solve + coaddition (the JAX package's ``solve_finalize``).

    A (n_pad, n_pad); mBhalf (n_out, m, n_pad); C (n_out,); kappaC (nv,);
    data (n_inframe, n_pad), zero in padding; img_onehot (n_pad, n_img);
    fade (m,) trapezoid factors; n2sq the n2**2 stamp-weight normalization.
    solver: "monolithic" (Cholesky, any number of kappa nodes), "eigen"
    (eigendecomposition + per-pixel bisection), "iterative" (masked CG over
    `relevant` (m, n_pad) bool, at `rtol` / `maxiter`; `exact_UC` selects
    the exact quality contraction) or "empirical" (distance weights from
    `dist` (m, n_pad) and `rho_acc`; with `no_qlt_ctrl`, EMPIRNQC, A and
    mBhalf are not read and may be None).  `relevant` and `dist` are read
    only by the solvers that need them.  Neff is 0 where T is not finite
    (an EMPIRNQC pixel with no input in reach), as on the host path.

    Returns a dict of float32 tensors: outimage (n_out, n_inframe, m),
    Tsum_stamp (n_out, n_img), Tsum_inpix, Neff, kappa, Sigma, UC
    (n_out, m), with the fade applied where the host path applies it.
    """
    f64 = torch.float64
    sys_ = tuple(None if t is None else t.to(f64) for t in (A, mBhalf, C, kappaC))
    if solver == "monolithic":
        T, kappa, Sigma, UC = cholesky_solve(*sys_, ucmin, smax)
    elif solver == "eigen":
        T, kappa, Sigma, UC = eigen_solve(*sys_, ucmin, smax)
    elif solver == "iterative":
        T, kappa, Sigma, UC = iterative_solve(*sys_, relevant, rtol, ucmin, smax,
                                              maxiter=maxiter, exact_UC=exact_UC)
        # CG quality estimates can round below zero; clamp like the host
        # path does before the fade
        UC = UC.clamp(min=1e-32)
        Sigma = Sigma.clamp(min=1e-32)
    elif solver == "empirical":
        T, kappa, Sigma, UC = empirical_weights(*sys_, dist.to(f64), rho_acc,
                                                no_qlt_ctrl=no_qlt_ctrl)
    else:
        raise ValueError(f"unknown solver {solver!r}")
    fade64 = fade.to(f64)
    Tf = T * fade64[None, :, None]                           # (n_out, m, n)

    outimage = torch.einsum("omn,fn->ofm", Tf, data.to(f64))
    Tsum_image = torch.einsum("omn,ni->omi", Tf, img_onehot.to(f64))
    Tsum_stamp = Tsum_image.sum(dim=1) / n2sq                # (n_out, n_img)
    Tsum_inpix = Tsum_image.sum(dim=2)                       # (n_out, m)
    absum = Tsum_image.abs().sum(dim=2)
    Tnorm = Tsum_image / torch.where(absum == 0, 1.0, absum)[:, :, None]
    sq = (Tnorm * Tnorm).sum(dim=2)
    Neff = torch.nan_to_num(torch.where(sq == 0, 0.0, 1.0 / torch.where(sq == 0, 1.0, sq)),
                            nan=0.0)

    f32 = torch.float32
    return {
        "outimage": outimage.to(f32),
        "Tsum_stamp": Tsum_stamp.to(f32),
        "Tsum_inpix": Tsum_inpix.to(f32),
        "Neff": (Neff * fade64[None, :]).to(f32),
        "kappa": (kappa * fade64[None, :]).to(f32),
        "Sigma": (Sigma * fade64[None, :]).to(f32),
        "UC": (UC * fade64[None, :]).to(f32),
    }


def solve_finalize_batch(A, mBhalf, C, kappaC, data, img_onehot, fade, relevant,
                         ucmin, smax, rtol, n2sq: int, solver: str = "monolithic",
                         exact_UC: bool = True, maxiter: int = 30, dist=None,
                         rho_acc: float = 0.0, no_qlt_ctrl: bool = False):
    """:func:`solve_finalize` over the group's stamp axis: A (S, n, n),
    mBhalf (S, n_out, m, n) (both None under `no_qlt_ctrl`), data (S,
    n_inframe, n), img_onehot (S, n, n_img), relevant (S, m, n) or (S, 1,
    1), dist (S, m, n) or None; each output gains a leading S axis.  The
    stamps are solved one after another, which bounds the working set to
    one stamp's."""
    outs = [solve_finalize(None if A is None else A[s],
                           None if mBhalf is None else mBhalf[s], C, kappaC, data[s],
                           img_onehot[s], fade, relevant[s], ucmin, smax, rtol, n2sq,
                           solver, exact_UC, maxiter, None if dist is None else dist[s],
                           rho_acc, no_qlt_ctrl)
            for s in range(data.shape[0])]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
