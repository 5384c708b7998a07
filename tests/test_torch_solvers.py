"""pyimcom_tpu_torch.solvers against the JAX package's Cholesky kernel.

The analytic Gaussian-overlap system of tests/test_solvers.py (its `system`
fixture), solved by both packages in float64 on the CPU at one kappa node:
T agrees to 1e-10 relative to its scale, U/C and Sigma to 1e-12 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyimcom_tpu.solvers import cholesky_solve as ref_cholesky_solve
from test_solvers import SMAX, UCMIN, system  # noqa: F401  (shared fixture)
from pyimcom_tpu_torch.convert import from_numpy
from pyimcom_tpu_torch.solvers import cholesky_solve
from pyimcom_tpu_torch.solvers.kernels import _safe_cholesky

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _numpy(system):
    """The analytic system of tests/test_solvers.py as NumPy arrays."""
    A, B, C, _dist = system
    return np.asarray(A), np.asarray(B), np.asarray(C)


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


def test_padding_neutrality(system):
    """Zero-padded coordinates (A diag 1, B cols 0) must not change results."""
    A, B, C = _numpy(system)
    kC = np.array([5e-4])
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


def test_multi_kappa_raises(system):
    A, B, C = _numpy(system)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cholesky_solve(*from_numpy([A, B, C, np.array([1e-4, 1e-3])], CPU),
                       UCMIN, SMAX)
