"""pyimcom_tpu_torch.psfgrp against the JAX package's PSF groups on the CPU.

Sampled PSFs, overlap stacks and the target normalizations C agree with the
reference's float64 CPU path to 1e-12 of their scale (FFT and summation
orders differ).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyimcom_tpu.psfgrp as ref
from pyimcom_tpu.ops.psfmodels import psf_gaussian
from pyimcom_tpu_torch import psfgrp

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def geoms():
    return (ref.PSFGeometry(npixpsf=16, oversamp=4, dtheta=0.04 / 3600),
            psfgrp.PSFGeometry(npixpsf=16, oversamp=4, dtheta=0.04 / 3600))


@pytest.fixture(scope="module")
def psfs(geoms):
    g, _ = geoms
    rng = np.random.default_rng(0)
    a = np.stack([psf_gaussian(g.nsamp, 5.0 + i, 4.0 + 0.5 * i) for i in range(3)])
    a = a * (1.0 + 0.05 * rng.standard_normal(a.shape))   # break symmetry
    b = psf_gaussian(g.nsamp, 6.0, 6.0)[None]
    return a, b


def _scale_close(got, want, tol=1e-12):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("amp", [(0.0, 0.0), (0.3, 1.5)])
def test_overlap_stacks_and_C_match_reference(geoms, psfs, amp):
    gr, gt = geoms
    a, b = psfs
    r1, r2 = ref.PSFGroup(gr, a, amp_penalty=amp), ref.PSFGroup(gr, b, amp_penalty=amp)
    t1 = psfgrp.PSFGroup(gt, a, device=CPU, amp_penalty=amp)
    t2 = psfgrp.PSFGroup(gt, b, device=CPU, amp_penalty=amp)
    for g2r, g2t in ((None, None), (r2, t2)):
        want = np.asarray(ref.build_overlap_stack(gr, r1, g2r))
        got = psfgrp.build_overlap_stack(gt, t1, g2t).numpy()
        assert got.shape == want.shape
        _scale_close(got, want)
    _scale_close(psfgrp.outpsf_C_values(gt, t2), ref.outpsf_C_values(gr, r2))


def test_psf_circ_and_norm_match_reference(geoms, psfs):
    gr, gt = geoms
    a, _ = psfs
    r = ref.PSFGroup(gr, a, psf_circ=True, psf_norm=True)
    t = psfgrp.PSFGroup(gt, a, device=CPU, psf_circ=True, psf_norm=True)
    _scale_close(psfgrp.build_overlap_stack(gt, t, None).numpy(),
                 np.asarray(ref.build_overlap_stack(gr, r, None)))


def test_rotated_sampling_matches_reference(geoms):
    """Batched rotated resampling (the dense entry; K1 on the card) against
    the reference's per-PSF gather sampling."""
    gr, gt = geoms
    rng = np.random.default_rng(5)
    raw = [psf_gaussian(70, 6.0 + i, 5.0) * (1 + 0.01 * rng.standard_normal((70, 70)))
           for i in range(2)]

    def rot(theta, s):
        c, sn = np.cos(theta), np.sin(theta)
        return lambda xy: s * np.stack([c * xy[:, 0] - sn * xy[:, 1],
                                        sn * xy[:, 0] + c * xy[:, 1]], axis=-1)

    mapfns = [rot(0.3, 0.37), rot(-1.1, 0.36)]
    cp = [12.5, -3.5]
    got = psfgrp.sample_psf_rotated_batch(gt, raw, mapfns, cp, device=CPU).numpy()
    for g in range(2):
        want = ref.sample_psf_rotated(gr, raw[g], mapfns[g], cp)
        _scale_close(got[g], want)


def test_unrotated_sampling_matches_reference(geoms):
    gr, gt = geoms
    p = np.stack([psf_gaussian(gr.nsamp + 1, 7.0, 7.0),
                  psf_gaussian(gr.nsamp + 1, 5.0, 6.0)])
    got = psfgrp.sample_psf_unrotated(gt, p, device=CPU).numpy()
    _scale_close(got, ref.sample_psf_unrotated(gr, p))


def test_image_runs_and_buckets_match_reference():
    idx = np.array([0, 0, 2, 2, 2, 5, 1, 1], np.int32)
    assert psfgrp._image_runs(idx) == ref._image_runs(idx)
    assert psfgrp._image_runs(np.zeros(0, np.int32)) == []
    assert psfgrp._DENSE_BUCKETS == ref._DENSE_BUCKETS
    assert psfgrp._DENSE_RBATCH_BY_BUCKET == ref._DENSE_RBATCH_BY_BUCKET
    assert psfgrp.INTERP_PAD == ref.INTERP_PAD
