"""pyimcom_tpu_torch.solvers against the JAX package's Cholesky kernel.

The analytic Gaussian-overlap system of tests/test_solvers.py (its `system`
fixture), solved by both packages in float64 on the CPU: at one kappa node T
agrees to 1e-10 relative to its scale and U/C and Sigma to 1e-12 absolute.
At several nodes kappa, Sigma and U/C agree to 1e-10 absolute and T to 1e-9
of its scale: the per-pixel node-weight systems are nearly singular
(near-duplicate node solutions), and the reference's own T moves by 2.2e-10
of its scale when A is perturbed by one ulp, so 1e-10 is below the floor
that any second LAPACK build can meet.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyimcom_tpu.solvers import cholesky_solve as ref_cholesky_solve
from pyimcom_tpu.solvers import kernels as ref_kernels
from test_solvers import SMAX, UCMIN, system  # noqa: F401  (shared fixture)
from test_torch_block import port_vs_reference, small_survey  # noqa: F401
from pyimcom_tpu_torch.convert import from_numpy
from pyimcom_tpu_torch.solvers import cholesky_solve
from pyimcom_tpu_torch.solvers import kernels
from pyimcom_tpu_torch.solvers.kernels import _safe_cholesky

torch.set_num_threads(1)
CPU = torch.device("cpu")


MULTI = [1e-5, 1e-4, 1e-3]


def _numpy(system):
    """The analytic system of tests/test_solvers.py as NumPy arrays."""
    A, B, C, _dist = system
    return np.asarray(A), np.asarray(B), np.asarray(C)


def assert_matches(got, want, tol=1e-10, t_tol=1e-10):
    """(T, kappa, Sigma, UC) of the port against the reference's: T to
    `t_tol` of its scale, the maps to `tol` absolute."""
    T, Tw = got[0].numpy(), np.asarray(want[0])
    np.testing.assert_allclose(T, Tw, rtol=0, atol=t_tol * np.abs(Tw).max())
    for name, g, w in zip(("kappa", "Sigma", "UC"), got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("kappa", [5e-4, 1e-2])
def test_single_kappa_matches_reference(system, kappa):
    A, B, C = _numpy(system)
    kC = np.array([kappa])
    want = ref_cholesky_solve(jnp.asarray(A), jnp.asarray(B), jnp.asarray(C),
                              jnp.asarray(kC), UCMIN, SMAX)
    got = cholesky_solve(*from_numpy([A, B, C, kC], CPU), UCMIN, SMAX)
    T, Tw = got[0].numpy(), np.asarray(want[0])
    np.testing.assert_allclose(T, Tw, rtol=0, atol=1e-10 * np.abs(Tw).max())
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)


def test_padding_neutrality(system, kappaC=(5e-4,)):
    """Zero-padded coordinates (A diag 1, B cols 0) must not change results."""
    A, B, C = _numpy(system)
    kC = np.array(kappaC)
    n = A.shape[0]
    npad = n + 17
    Ap = np.eye(npad)
    Ap[:n, :n] = A
    Bp = np.zeros((1, B.shape[1], npad))
    Bp[:, :, :n] = B
    T0, k0, S0, U0 = cholesky_solve(*from_numpy([A, B, C, kC], CPU), UCMIN, SMAX)
    T1, k1, S1, U1 = cholesky_solve(*from_numpy([Ap, Bp, C, kC], CPU), UCMIN, SMAX)
    np.testing.assert_allclose(T1[:, :, :n].numpy(), T0.numpy(), rtol=0, atol=1e-10)
    assert T1[:, :, n:].abs().max() < 1e-14
    np.testing.assert_allclose(U1.numpy(), U0.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(S1.numpy(), S0.numpy(), rtol=0, atol=1e-10)


def test_safe_cholesky_repairs_indefinite_matrix():
    """A not positive definite is shifted by |lambda_min| + 1e-16."""
    A = torch.tensor([[1.0, 2.0], [2.0, 1.0]], dtype=torch.float64)   # eigs -1, 3
    L = _safe_cholesky(A, A)
    shift = 1.0 + 1e-16
    np.testing.assert_allclose((L @ L.T).numpy(),
                               (A + shift * torch.eye(2, dtype=torch.float64)).numpy(),
                               rtol=0, atol=1e-12)


def test_padding_neutrality_multi_kappa(system):
    test_padding_neutrality(system, MULTI)


def _multi(system, kappaC):
    A, B, C = _numpy(system)
    kC = np.array(kappaC)
    want = ref_cholesky_solve(*(jnp.asarray(a) for a in (A, B, C, kC)), UCMIN, SMAX)
    return cholesky_solve(*from_numpy([A, B, C, kC], CPU), UCMIN, SMAX), want


def test_multi_kappa_raises(system):
    """Several kappa nodes (those of BASELINE.json configs[1]): the node
    solves, cross products and per-pixel node-weight search reproduce the
    reference's multi-kappa Cholesky."""
    assert_matches(*_multi(system, [5e-4, 1e-3, 2e-3]), t_tol=1e-9)


def test_multi_kappa_small_nodes_match_reference(system):
    """The reference's own node set, down to kappa/C = 1e-5 (A + kappa I
    has condition number ~7e6 there)."""
    assert_matches(*_multi(system, MULTI), t_tol=1e-9)


@pytest.mark.parametrize("exact_E", [False, True], ids=["cheap_E", "exact_E"])
def test_node_cross_products_and_weights_match_reference(system, exact_E):
    """_node_cross_products and _reduced_T_weights on identical node
    solutions: D, N, E to 1e-12 of scale; kappa, Sigma and U/C to 1e-10
    absolute, the node weights w to 1e-9 of their scale (the nearly
    singular nv x nv systems, as in the module docstring)."""
    A, B, C = _numpy(system)
    kC = np.array(MULTI)
    kap = kC * C[0]
    Tpi = np.stack([np.linalg.solve(A + k * np.eye(len(A)), B[0].T).T for k in kap])
    want = ref_kernels._node_cross_products(jnp.asarray(A), jnp.asarray(B[0]),
                                            jnp.asarray(Tpi), jnp.asarray(kap), exact_E)
    At, Bt, Tt, kt = from_numpy([A, B[0], Tpi, kap], CPU)
    got = kernels._node_cross_products(At, Bt, Tt, kt, exact_E)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-12 * np.abs(w).max())

    Dp, Npq, Epq = (np.asarray(w) for w in want)
    want = ref_kernels._reduced_T_weights(jnp.asarray(Npq), jnp.asarray(Dp / C[0]),
                                          jnp.asarray(Epq / C[0]), jnp.asarray(kC),
                                          UCMIN, SMAX)
    got = kernels._reduced_T_weights(*from_numpy([Npq, Dp / C[0], Epq / C[0], kC], CPU),
                                     UCMIN, SMAX)
    for name, g, w, tol in zip(("kappa", "Sigma", "UC", "w"), got, want,
                               (1e-10, 1e-10, 1e-10, 1e-9 * np.abs(want[3]).max())):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=tol,
                                   err_msg=name)


def test_multi_kappa_block_matches_reference(small_survey, monkeypatch):
    """Multi-kappa Cholesky (the nodes of BASELINE.json configs[1]) through
    the whole block against the reference's device group engine: science
    cube to 1e-8 of scale, maps (KAPPA included) to 1 LSB."""
    out = port_vs_reference(small_survey, monkeypatch, "_mk", "1",
                            KAPPAC=[5e-4, 1e-3, 2e-3])
    from pyimcom_tpu.fitsio import fits_read

    assert "KAPPA" in {h.header.get("EXTNAME") for h in fits_read(out)}
