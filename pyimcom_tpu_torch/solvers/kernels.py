"""
Linear-algebra kernels for the IMCOM coaddition matrix T, on PyTorch.

Counterpart of pyimcom_tpu/solvers/kernels.py.  Given one stamp's system
    A      : (n, n)        input-input PSF overlaps
    -B/2   : (n_out, m, n) input-target overlaps ("mBhalf")
    C      : (n_out,)      target self-overlap at zero lag
solve T = (A + kappa I)^{-1} (-B/2) and report the quality maps U/C, Sigma
and kappa.  This PR ports the single-kappa Cholesky kernel, in float64
(cuSOLVER on the card, LAPACK on the CPU).

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


def cholesky_solve(A, mBhalf, C, kappaC, ucmin, smax):
    """
    Cholesky kernel at a single kappa node: T = (A + kappa_j I)^{-1} (-B/2)_j
    with kappa_j = kappaC[0] * C[j] for each target PSF j.

    Shapes as above, kappaC (1,).  Returns (T (n_out, m, n), kappa, Sigma,
    UC (n_out, m)).  `ucmin` and `smax` steer only the multi-kappa node
    search, which is not ported yet: more than one node raises.
    """
    if kappaC.shape[0] != 1:
        raise NotImplementedError(
            "multi-kappa Cholesky (KAPPAC with more than one node) is not "
            "ported to pyimcom_tpu_torch yet; see ROADMAP.md queue 1, "
            "'Multi-kappa Cholesky'")
    n = A.shape[0]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    Ts, kappas, Sigmas, UCs = [], [], [], []
    for j in range(C.shape[0]):
        kap = kappaC[0] * C[j]
        mb = mBhalf[j]                                      # (m, n)
        L = _safe_cholesky(A + kap * eye, A)
        Ti = torch.cholesky_solve(mb.T, L).T                # (m, n)
        D = (mb * Ti).sum(dim=-1)
        N = (Ti * Ti).sum(dim=-1)
        Ts.append(Ti)
        kappas.append(kap.expand(D.shape))
        Sigmas.append(N)
        UCs.append(1.0 - (kap * N + D) / C[j])
    return (torch.stack(Ts), torch.stack(kappas), torch.stack(Sigmas),
            torch.stack(UCs))
