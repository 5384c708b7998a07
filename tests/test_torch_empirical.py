"""The Empirical kernel of pyimcom_tpu_torch against the JAX package's.

empirical_weights (distance-weighted T, no solve; U/C and Sigma exact from
A) on the analytic system of tests/test_solvers.py, in float64 on the CPU:
T to 1e-10 of its scale, kappa, Sigma and U/C to 1e-10 absolute.
"""

import jax.numpy as jnp
import numpy as np
import torch

from pyimcom_tpu.solvers import empirical_weights as ref_empirical_weights
from test_solvers import system  # noqa: F401  (shared fixture)
from test_torch_solvers import _numpy, assert_matches
from test_torch_block import port_vs_reference, small_survey  # noqa: F401
from pyimcom_tpu_torch.convert import from_numpy
from pyimcom_tpu_torch.solvers import empirical_weights

torch.set_num_threads(1)
CPU = torch.device("cpu")


def test_empirical_matches_reference(system):
    A, B, C = _numpy(system)
    dist = np.asarray(system[3])
    kC = np.array([5e-4])
    want = ref_empirical_weights(*(jnp.asarray(a) for a in (A, B, C, kC, dist)), 6.0)
    got = empirical_weights(*from_numpy([A, B, C, kC, dist], CPU), 6.0)
    assert_matches(got, want)
    np.testing.assert_allclose(got[0].sum(dim=-1).numpy(), 1.0, rtol=0, atol=1e-12)


def test_empirical_padding_neutrality(system):
    """Padded coordinates sit at the 1e6 distance sentinel: zero weight,
    unchanged maps."""
    A, B, C = _numpy(system)
    dist = np.asarray(system[3])
    kC = np.array([5e-4])
    n = A.shape[0]
    Ap = np.eye(n + 17)
    Ap[:n, :n] = A
    Bp = np.zeros((1, B.shape[1], n + 17))
    Bp[:, :, :n] = B
    distp = np.full((dist.shape[0], n + 17), 1e6)
    distp[:, :n] = dist
    T0, k0, S0, U0 = empirical_weights(*from_numpy([A, B, C, kC, dist], CPU), 6.0)
    T1, k1, S1, U1 = empirical_weights(*from_numpy([Ap, Bp, C, kC, distp], CPU), 6.0)
    np.testing.assert_allclose(T1[:, :, :n].numpy(), T0.numpy(), rtol=0, atol=1e-15)
    assert T1[:, :, n:].abs().max() == 0.0
    for a, b in ((k1, k0), (S1, S0), (U1, U0)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12)


def test_block_matches_reference(small_survey, monkeypatch):
    """Empirical with quality control through the whole block against the
    reference's host solve path (its only path for Empirical)."""
    port_vs_reference(small_survey, monkeypatch, "_empirical", "0",
                      LAKERNEL="Empirical")
