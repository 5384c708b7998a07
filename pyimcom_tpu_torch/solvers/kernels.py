"""
Linear-algebra kernels for the IMCOM coaddition matrix T, on PyTorch.

Counterpart of pyimcom_tpu/solvers/kernels.py.  Given one stamp's system
    A      : (n, n)        input-input PSF overlaps
    -B/2   : (n_out, m, n) input-target overlaps ("mBhalf")
    C      : (n_out,)      target self-overlap at zero lag
solve T(kappa) = (A + kappa I)^{-1} (-B/2), with kappa chosen per output
pixel (when KAPPAC has several nodes) to reach the leakage target U/C <=
ucmin under the noise bound Sigma <= smax, and report the quality maps U/C,
Sigma and kappa.  Four strategies, as in the JAX package:

* :func:`eigen_solve`       -- eigendecomposition; per-pixel kappa bisection;
* :func:`cholesky_solve`    -- Cholesky at each kappa node + node-weight search;
* :func:`iterative_solve`   -- masked conjugate gradient for every output pixel;
* :func:`empirical_weights` -- distance-weighted T without a solve.

Everything is float64 (cuSOLVER / cuBLAS on the card, LAPACK on the CPU)
and batched over output pixels, as the JAX package batches it.  What the
JAX package added only for the TPU -- the blocked Cholesky, the
mixed-precision factorization and the dense-kappa-grid emulation of the
Eigen kernel -- is not ported: the card factors and diagonalizes in f64.

Padding convention (as in the JAX package): pad A with 1 on the diagonal
and mBhalf with zero columns; padded coordinates get exactly zero weight.
"""

from __future__ import annotations

import torch


def _safe_cholesky(AA: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """
    Lower Cholesky factor of AA with negative-eigenvalue repair: if AA is
    not numerically positive definite, shift the diagonal by
    |lambda_min(A)| + 1e-16 and factor again (reference lakernel.py:241-279).
    """
    L, info = torch.linalg.cholesky_ex(AA)
    if int(info) != 0:
        shift = torch.linalg.eigvalsh(A)[0].abs() + 1e-16
        eye = torch.eye(AA.shape[0], dtype=AA.dtype, device=AA.device)
        L = torch.linalg.cholesky(AA + shift * eye)
    return L


def _quad(A, T):
    """T_a^T A T_a for every row a of T (m, n)."""
    return ((T @ A) * T).sum(dim=-1)


# ---------------------------------------------------------------------------
# Eigendecomposition kernel
# ---------------------------------------------------------------------------

def eigen_solve(A, mBhalf, C, kappaC, ucmin, smax, nbis: int = 13):
    """
    Eigendecomposition kernel (contract of reference lakernel.py:141-224 and
    routine.py:341-430): diagonalize A once, then solve every kappa in the
    eigenbasis.  kappaC (nv,) ascending; nv == 1 is the fixed-kappa path,
    nv > 1 runs `nbis` geometric bisection steps per output pixel between
    the end nodes.  Returns (T (n_out, m, n), kappa, Sigma, UC (n_out, m)).
    """
    lam, Q = torch.linalg.eigh(A)
    mPhalf = mBhalf @ Q                                     # (n_out, m, n)

    def quality(kap):                                       # kap (n_out, m | 1)
        var = mPhalf / (lam + kap[..., None])
        Sigma = (var * var).sum(dim=-1)
        UC = 1.0 - ((lam + 2.0 * kap[..., None]) * var * var).sum(dim=-1) / C[:, None]
        return var, Sigma, UC

    if kappaC.shape[0] == 1:
        my_kappa = kappaC[0] * C                            # (n_out,)
        var, Sigma, UC = quality(my_kappa[:, None])
        return var @ Q.T, my_kappa[:, None].expand_as(UC), Sigma, UC

    kCmin = kappaC[0] * C
    kCmax = kappaC[-1] * C
    ones = torch.ones_like(mPhalf[:, :, 0])
    kap = torch.sqrt(kCmax * kCmin)[:, None] * ones
    factor = torch.sqrt(kCmax / kCmin)[:, None] * ones
    for _ in range(nbis):
        _var, sum2, udc = quality(kap)
        factor = torch.sqrt(factor)
        shrink = (udc > ucmin) & (sum2 < smax)
        kap = kap * torch.where(shrink, 1.0 / factor, factor)
    var, Sigma, UC = quality(kap)
    # the reference multiplies the reported kappa map by C once more on this
    # path (lakernel.py:222); reproduced for output parity
    return var @ Q.T, kap * C[:, None], Sigma, UC


# ---------------------------------------------------------------------------
# Node-weight machinery shared by the Cholesky and iterative kernels
# ---------------------------------------------------------------------------

def _node_cross_products(A, mBhalf_j, Tpi, kappa_arr, exact_E: bool):
    """D_p (m, nv), N_pq and E_pq (m, nv, nv) at the kappa nodes for one
    target PSF.  E_pq = T_p^T A T_q; the cheap form uses A T_q = mBhalf -
    kappa_q T_q (D_q - kappa_p N_pq on the symmetrized triangle, reference
    lakernel.py:362-368), the exact form contracts through A."""
    nv = Tpi.shape[0]
    Dp = torch.einsum("ai,pai->ap", mBhalf_j, Tpi)
    Npq = torch.einsum("pai,qai->apq", Tpi, Tpi)
    if exact_E:
        Epq = torch.einsum("pai,qai->apq", Tpi, Tpi @ A)
        Epq = 0.5 * (Epq + Epq.transpose(-1, -2))
    else:
        idx = torch.arange(nv, device=Tpi.device)
        lo = torch.minimum(idx[:, None], idx[None, :])
        hi = torch.maximum(idx[:, None], idx[None, :])
        Epq = Dp[:, lo] - kappa_arr[hi][None, :, :] * Npq
    return Dp, Npq, Epq


def _reduced_T_weights(Npq, DoverC, EoverC, nodes, ucmin, smax, niter: int = 12):
    """
    Per-pixel kappa-interval search and node-weight solve (contract of
    reference routine.py:487-588): pick the kappa interval from the
    diagonal node quality values, then run `niter` geometric refinement
    steps, each solving the nv x nv system (E/C + kappa N) w = D/C for all m
    pixels at once (one batched Cholesky).

    Returns (kappa, Sigma, UC, w) with shapes (m,), (m,), (m,), (m, nv).
    """
    m, nv = DoverC.shape
    S_diag = Npq.diagonal(dim1=-2, dim2=-1)                  # (m, nv)
    UC_diag = 1.0 - 2.0 * DoverC + EoverC.diagonal(dim1=-2, dim2=-1)

    # interval lower node: the walk from iv = nv-2 downward stops at the
    # first node where the quality target is already met (UC <= ucmin) or
    # the noise bound is violated (S >= smax); otherwise it ends at 0
    stop = (UC_diag[:, :nv - 1] <= ucmin) | (S_diag[:, :nv - 1] >= smax)
    below = torch.arange(nv - 1, device=DoverC.device)[None, :]
    iv = torch.where(stop, below, 0).amax(dim=-1)           # (m,)

    kappamid = torch.sqrt(nodes[iv] * nodes[iv + 1])
    factor = (nodes[iv + 1] / nodes[iv]) ** 0.25
    eye = torch.eye(nv, dtype=DoverC.dtype, device=DoverC.device)
    for _ in range(niter):
        M = EoverC + kappamid[:, None, None] * Npq           # (m, nv, nv)
        # closely spaced nodes give near-duplicate T_p and a numerically
        # singular M: a 1e-11-relative Tikhonov diagonal keeps the factor
        # finite (as in the JAX package)
        diag = M.diagonal(dim1=-2, dim2=-1).abs().mean(dim=-1)
        L, _info = torch.linalg.cholesky_ex(M + (1e-11 * diag)[:, None, None] * eye)
        w = torch.cholesky_solve(DoverC[..., None], L)[..., 0]   # (m, nv)
        S = torch.einsum("ap,apq,aq->a", w, Npq, w)
        UC = 1.0 - kappamid * S - (DoverC * w).sum(dim=-1)
        ok = (UC > ucmin) & (S < smax)
        kappamid = kappamid * torch.where(ok, 1.0 / factor, factor)
        factor = torch.sqrt(factor)
    # kappa is reported after the final update, S / UC / w from the final
    # solve (the reference's loop structure, routine.py:560-588)
    return kappamid, S, UC, w


def _blend_nodes(A, mb, Tpi, kappaC, Cj, ucmin, smax, exact_E: bool):
    """Blend the node solutions Tpi (nv, m, n) of target PSF j per pixel:
    returns (T (m, n), kappa, Sigma, UC (m,))."""
    Dp, Npq, Epq = _node_cross_products(A, mb, Tpi, kappaC * Cj, exact_E)
    kappamid, S, UC, w = _reduced_T_weights(Npq, Dp / Cj, Epq / Cj, kappaC,
                                            ucmin, smax)
    return torch.einsum("pai,ap->ai", Tpi, w), kappamid * Cj, S, UC


def _stack_outputs(per_output):
    return tuple(torch.stack(t) for t in zip(*per_output))


# ---------------------------------------------------------------------------
# Cholesky kernel
# ---------------------------------------------------------------------------

def cholesky_solve(A, mBhalf, C, kappaC, ucmin, smax):
    """
    Cholesky kernel: factor A + kappa I at each kappa node kappaC * C[j],
    solve for the node T matrices, then (nv > 1) blend them per pixel with
    the node-weight search.  Shapes as in :func:`eigen_solve`.

    Each factorization reads its ``info`` on the host (the repair branch of
    :func:`_safe_cholesky`): one synchronization per node and target PSF.
    """
    n = A.shape[0]
    nv = kappaC.shape[0]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    per_output = []
    for j in range(C.shape[0]):
        mb = mBhalf[j]                                       # (m, n)
        Tpi = torch.stack([
            torch.cholesky_solve(mb.T, _safe_cholesky(A + kap * eye, A)).T
            for kap in kappaC * C[j]])                       # (nv, m, n)
        if nv == 1:
            kap = kappaC[0] * C[j]
            Ti = Tpi[0]
            D = (mb * Ti).sum(dim=-1)
            N = (Ti * Ti).sum(dim=-1)
            per_output.append((Ti, kap.expand(D.shape), N, 1.0 - (kap * N + D) / C[j]))
        else:
            per_output.append(_blend_nodes(A, mb, Tpi, kappaC, C[j], ucmin, smax,
                                           exact_E=False))
    return _stack_outputs(per_output)


# ---------------------------------------------------------------------------
# Iterative (masked conjugate gradient) kernel
# ---------------------------------------------------------------------------

def _masked_cg(AA, B, mask, rtol, maxiter: int):
    """
    Solve AA_sub x_sub = b_sub for every output pixel at once: `mask` (m, n)
    selects each pixel's relevant input pixels, and keeping the iterates
    zero outside it makes this exactly CG on the extracted submatrix (the
    reference's per-pixel path, lakernel.py:548-590) as (m, n) x (n, n)
    matmuls.  Converged pixels freeze (alpha = 0), the per-pixel early break.
    """
    Bm = B * mask
    atol = torch.linalg.vector_norm(Bm, dim=-1) * rtol      # (m,)
    x = torch.zeros_like(Bm)
    r = p = Bm
    rho_prev = None
    for _ in range(maxiter):
        rho = (r * r).sum(dim=-1)
        active = torch.sqrt(rho) >= atol
        if rho_prev is not None:
            beta = rho / torch.where(rho_prev == 0, 1.0, rho_prev)
            p = torch.where(active[:, None], p * beta[:, None] + r, p)
        q = (p @ AA) * mask
        pq = (p * q).sum(dim=-1)
        alpha = torch.where(active, rho / torch.where(pq == 0, 1.0, pq), 0.0)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * q
        rho_prev = rho
    return x


def iterative_solve(A, mBhalf, C, kappaC, relevant, rtol, ucmin, smax,
                    maxiter: int = 30, exact_UC: bool = True):
    """
    Iterative kernel: masked CG per output pixel at each kappa node.
    relevant (m, n) bool is the acceptance-radius mask of every output
    pixel.  With one node, `exact_UC` selects the exact T^T A T contraction
    for U/C over the cheap estimate; with several nodes it selects the exact
    node cross products.
    """
    n = A.shape[0]
    nv = kappaC.shape[0]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    maskf = relevant.to(A.dtype)
    per_output = []
    for j in range(C.shape[0]):
        mb = mBhalf[j]
        Tpi = torch.stack([_masked_cg(A + kap * eye, mb, maskf, rtol, maxiter)
                           for kap in kappaC * C[j]])
        if nv == 1:
            kap = kappaC[0] * C[j]
            Ti = Tpi[0]
            D = (mb * Ti).sum(dim=-1)
            N = (Ti * Ti).sum(dim=-1)
            if exact_UC:
                UC = 1.0 + (_quad(A, Ti) - 2 * D) / C[j]
            else:
                UC = 1.0 - (kap * N + D) / C[j]
            per_output.append((Ti, kap.expand(D.shape), N, UC))
        else:
            per_output.append(_blend_nodes(A, mb, Tpi, kappaC, C[j], ucmin, smax,
                                           exact_E=exact_UC))
    return _stack_outputs(per_output)


# ---------------------------------------------------------------------------
# Empirical kernel
# ---------------------------------------------------------------------------

def empirical_weights(A, mBhalf, C, kappaC, dist, rho_acc, no_qlt_ctrl: bool = False):
    """
    Distance-weighted "kernel" (reference lakernel.py:747-806): T_ai
    proportional to max(rho_acc - dist_ai, 0), row-normalized, no solve.
    dist (m, n) output-to-input pixel distances in output pixels.  With
    quality control U/C and Sigma are evaluated exactly from A; without it
    (EMPIRNQC) A and mBhalf are not read (they may be None) and kappa,
    Sigma and U/C are zero.  An output pixel with no input within rho_acc
    gets 0/0 weights, as in the JAX package.
    """
    Ti = (rho_acc - dist).clamp(min=0.0)
    Ti = Ti / Ti.sum(dim=-1, keepdim=True)
    T = Ti[None].expand((C.shape[0],) + Ti.shape)
    if no_qlt_ctrl:
        zeros = torch.zeros(T.shape[:2], dtype=dist.dtype, device=dist.device)
        return T, zeros, zeros, zeros
    D = torch.einsum("oai,ai->oa", mBhalf, Ti)
    UC = 1.0 + (_quad(A, Ti)[None, :] - 2 * D) / C[:, None]
    Sigma = (Ti * Ti).sum(dim=-1)[None, :].expand_as(UC)
    kappa = (kappaC[0] * C)[:, None].expand_as(UC)
    return T, kappa, Sigma, UC


KERNELS = {
    "Eigen": eigen_solve,
    "Cholesky": cholesky_solve,
    "Iterative": iterative_solve,
    "Empirical": empirical_weights,
}
