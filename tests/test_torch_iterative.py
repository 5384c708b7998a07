"""The Iterative kernel of pyimcom_tpu_torch against the JAX package's.

iterative_solve (masked conjugate gradient for every output pixel, frozen
once converged) on the analytic system of tests/test_solvers.py, in float64
on the CPU, with the full mask and with the acceptance-radius mask, at one
and at several kappa nodes: T to 1e-10 of its scale, kappa, Sigma and U/C
to 1e-10 absolute.

The comparison runs 8 CG iterations, or freezes every pixel early with a
loose rtol.  On this redundant fixture finite-precision CG becomes chaotic
after ~12 iterations: at 30 the reference's own T moves by 1e-2 of its
scale when A is perturbed by one ulp, so no second implementation can be
held to it there.  At 8 iterations that floor is below 3e-11.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyimcom_tpu.solvers import iterative_solve as ref_iterative_solve
from test_solvers import SMAX, UCMIN, system  # noqa: F401  (shared fixture)
from test_torch_solvers import MULTI, _numpy, assert_matches
from test_torch_block import port_vs_reference, small_survey  # noqa: F401
from pyimcom_tpu_torch.convert import from_numpy
from pyimcom_tpu_torch.solvers import iterative_solve

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _mask(system, kind):
    dist = np.asarray(system[3])
    return np.ones(dist.shape, bool) if kind == "full" else dist < 4.0


def _compare(system, kappaC, mask, exact_UC, rtol=1e-3, maxiter=8):
    A, B, C = _numpy(system)
    kC = np.array(kappaC)
    rel = _mask(system, mask)
    args = (rtol, UCMIN, SMAX)
    want = ref_iterative_solve(*(jnp.asarray(a) for a in (A, B, C, kC, rel)), *args,
                               maxiter=maxiter, exact_UC=exact_UC)
    got = iterative_solve(*from_numpy([A, B, C, kC, rel], CPU), *args,
                          maxiter=maxiter, exact_UC=exact_UC)
    assert_matches(got, want)
    assert np.all(got[0].numpy()[:, ~rel] == 0.0)


@pytest.mark.parametrize("mask", ["full", "partial"])
@pytest.mark.parametrize("exact_UC", [False, True], ids=["cheap_UC", "exact_UC"])
def test_iterative_single_kappa_matches_reference(system, mask, exact_UC):
    _compare(system, [5e-4], mask, exact_UC)


@pytest.mark.parametrize("mask", ["full", "partial"])
def test_iterative_multi_kappa_matches_reference(system, mask):
    """Several nodes run with the exact node cross products, as the block
    coadd runs them (exact_UC = more than one KAPPAC node)."""
    _compare(system, [5e-4, 1e-3, 2e-3], mask, exact_UC=True)


@pytest.mark.parametrize("mask", ["full", "partial"])
def test_converged_pixels_freeze(system, mask):
    """With rtol 3e-2 every pixel converges and freezes well before 30
    iterations; the frozen solution equals the reference's."""
    _compare(system, [5e-4], mask, exact_UC=False, rtol=3e-2, maxiter=30)


def test_iterative_padding_neutrality(system):
    """Padded coordinates (A diag 1, B cols 0, outside every mask) must not
    change results."""
    A, B, C = _numpy(system)
    kC = np.array(MULTI)
    rel = _mask(system, "partial")
    n = A.shape[0]
    Ap = np.eye(n + 17)
    Ap[:n, :n] = A
    Bp = np.zeros((1, B.shape[1], n + 17))
    Bp[:, :, :n] = B
    relp = np.zeros((rel.shape[0], n + 17), bool)
    relp[:, :n] = rel
    T0, k0, S0, U0 = iterative_solve(*from_numpy([A, B, C, kC, rel], CPU), 1e-3,
                                     UCMIN, SMAX, maxiter=8)
    T1, k1, S1, U1 = iterative_solve(*from_numpy([Ap, Bp, C, kC, relp], CPU), 1e-3,
                                     UCMIN, SMAX, maxiter=8)
    np.testing.assert_allclose(T1[:, :, :n].numpy(), T0.numpy(), rtol=0, atol=1e-10)
    assert T1[:, :, n:].abs().max() == 0.0
    for a, b in ((k1, k0), (S1, S0), (U1, U0)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-10)


def test_block_matches_reference(small_survey, monkeypatch):
    """Iterative (ITERRTOL 1.5e-3, as in the reference's cross-kernel test)
    through the whole block against the reference's device group engine.
    ITERMAX is 8: at 30 iterations CG is past its chaotic point on these
    stamps too, and the reference's own host and device paths differ by
    1.5e-5 of the science scale (the port sits 2.8e-5 from either); at 8
    the port agrees with the reference to 2e-13 of scale."""
    port_vs_reference(small_survey, monkeypatch, "_iterative", "1",
                      LAKERNEL="Iterative", ITERRTOL=1.5e-3, ITERMAX=8)
