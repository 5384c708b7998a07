"""The Eigen kernel of pyimcom_tpu_torch against the JAX package's.

eigen_solve (eigendecomposition plus the 13-step per-pixel kappa bisection)
on the analytic system of tests/test_solvers.py, in float64 on the CPU:
T to 1e-10 of its scale, kappa, Sigma and U/C to 1e-10 absolute.  With
the reference's node set down to kappa/C = 1e-5, T is held to 1e-9 of its
scale: there the reference's own T moves by 9e-11 of its scale under a
one-ulp perturbation of A, so 1e-10 is at the floor of any second
eigensolver.  The port's Eigen is the true kernel, so it is held
against ``pyimcom_tpu.solvers.eigen_solve``, never against the TPU's
dense-kappa-grid emulation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyimcom_tpu.solvers import eigen_solve as ref_eigen_solve
from test_solvers import SMAX, UCMIN, system  # noqa: F401  (shared fixture)
from test_torch_solvers import MULTI, _numpy, assert_matches
from test_torch_block import port_vs_reference, small_survey  # noqa: F401
from pyimcom_tpu_torch.convert import from_numpy
from pyimcom_tpu_torch.solvers import eigen_solve

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.mark.parametrize("kappaC, t_tol", [([5e-4], 1e-10), (MULTI, 1e-9),
                                           ([5e-4, 1e-3, 2e-3], 1e-10)],
                         ids=["single", "multi", "configs1"])
def test_eigen_matches_reference(system, kappaC, t_tol):
    A, B, C = _numpy(system)
    kC = np.array(kappaC)
    want = ref_eigen_solve(*(jnp.asarray(a) for a in (A, B, C, kC)), UCMIN, SMAX)
    got = eigen_solve(*from_numpy([A, B, C, kC], CPU), UCMIN, SMAX)
    assert_matches(got, want, t_tol=t_tol)


def test_eigen_reports_kappa_times_C_on_the_multi_kappa_path(system):
    """The reference quirk: the multi-kappa path reports kappa * C once more
    (reference lakernel.py:222), so the map lies in the kappaC * C**2 node
    envelope."""
    A, B, C = _numpy(system)
    _T, kappa, _S, _U = eigen_solve(*from_numpy([A, B, C, np.array(MULTI)], CPU),
                                    UCMIN, SMAX)
    k = kappa.numpy() / C[0] ** 2
    assert np.all(k >= MULTI[0] / np.sqrt(10) * 0.99)
    assert np.all(k <= MULTI[-1] * np.sqrt(10) * 1.01)


@pytest.mark.parametrize("kappaC", [[5e-4], MULTI], ids=["single", "multi"])
def test_eigen_padding_neutrality(system, kappaC):
    """Zero-padded coordinates (A diag 1, B cols 0) must not change results."""
    A, B, C = _numpy(system)
    kC = np.array(kappaC)
    n = A.shape[0]
    Ap = np.eye(n + 17)
    Ap[:n, :n] = A
    Bp = np.zeros((1, B.shape[1], n + 17))
    Bp[:, :, :n] = B
    T0, k0, S0, U0 = eigen_solve(*from_numpy([A, B, C, kC], CPU), UCMIN, SMAX)
    T1, k1, S1, U1 = eigen_solve(*from_numpy([Ap, Bp, C, kC], CPU), UCMIN, SMAX)
    np.testing.assert_allclose(T1[:, :, :n].numpy(), T0.numpy(), rtol=0, atol=1e-10)
    assert T1[:, :, n:].abs().max() < 1e-14
    for a, b in ((k1, k0), (S1, S0), (U1, U0)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-10)


def test_block_matches_reference(small_survey, monkeypatch):
    """Multi-kappa Eigen through the whole block against the reference's host
    solve path (PYIMCOM_DEVICE_ASSEMBLY=0, which runs the true Eigen
    kernel; the reference's device engine runs the TPU emulation)."""
    port_vs_reference(small_survey, monkeypatch, "_eigen", "0",
                      LAKERNEL="Eigen", KAPPAC=[5e-4, 1e-3, 2e-3])
