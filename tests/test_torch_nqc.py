"""Empirical and Iterative without quality control (EMPIRNQC) in
pyimcom_tpu_torch against the JAX package.

The reference runs both on its host solve path.  Empirical+EMPIRNQC builds
no system: T is the row-normalized max(rho_acc - dist, 0), and kappa, Sigma
and U/C are zero.  Iterative+EMPIRNQC is the ordinary Iterative solve (the
flag only changes Empirical), which the port runs through its group engine.
The kernel is compared on the analytic system of tests/test_solvers.py in
float64: T to 1e-10 of its scale, the maps to 1e-10 absolute.  The block is
compared on the reduced survey at STOP 2 with port_vs_reference (the science
cube to 1e-8 of its scale or one float32 ulp, the maps to 1 LSB); Iterative
runs 8 CG iterations, below CG's chaotic point (test_torch_iterative.py).
Empirical+EMPIRNQC's block is held to the reference by the `empirnqc` case of
test_torch_block.test_configs_outside_the_slice_raise.
"""

import jax.numpy as jnp
import numpy as np
import torch

from pyimcom_tpu.solvers import empirical_weights as ref_empirical_weights
from test_solvers import system  # noqa: F401  (shared fixture)
from test_torch_solvers import _numpy, assert_matches
from test_torch_block import _cfg, port_vs_reference, small_survey  # noqa: F401
from pyimcom_tpu_torch.convert import from_numpy
from pyimcom_tpu_torch.solvers import empirical_weights

torch.set_num_threads(1)
CPU = torch.device("cpu")


def test_empirical_no_qlt_matches_reference(system):
    A, B, C = _numpy(system)
    dist = np.asarray(system[3])
    kC = np.array([5e-4])
    want = ref_empirical_weights(*(jnp.asarray(a) for a in (A, B, C, kC, dist)), 6.0,
                                 no_qlt_ctrl=True)
    got = empirical_weights(*from_numpy([A, B, C, kC, dist], CPU), 6.0, no_qlt_ctrl=True)
    assert_matches(got, want)
    for m in got[1:]:
        assert m.shape == (C.shape[0], dist.shape[0]) and m.abs().max() == 0.0
    # A and -B/2 are not read without quality control
    none = empirical_weights(None, None, *from_numpy([C, kC, dist], CPU), 6.0,
                             no_qlt_ctrl=True)
    for a, b in zip(none, got):
        assert torch.equal(a, b)


def test_empirical_no_qlt_unreached_pixel_matches_reference(system):
    """An output pixel with no input within rho_acc gets the reference's
    0/0 weights (NaN), at the same pixel."""
    A, B, C = _numpy(system)
    dist = np.asarray(system[3]).copy()
    dist[3] = 50.0
    kC = np.array([5e-4])
    want = ref_empirical_weights(*(jnp.asarray(a) for a in (A, B, C, kC, dist)), 6.0,
                                 no_qlt_ctrl=True)
    got = empirical_weights(*from_numpy([A, B, C, kC, dist], CPU), 6.0, no_qlt_ctrl=True)
    np.testing.assert_array_equal(np.isnan(got[0].numpy()), np.isnan(np.asarray(want[0])))
    assert np.isnan(got[0].numpy()[:, 3]).all()
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-15)


def test_iterative_no_qlt_block_matches_reference(small_survey, monkeypatch):
    port_vs_reference(small_survey, monkeypatch, "_iternqc", "0", LAKERNEL="Iterative",
                      EMPIRNQC=True, ITERMAX=8)


def test_empirical_no_qlt_block_builds_no_system(small_survey):
    """Empirical+EMPIRNQC skips PSF groups, overlap stacks, the sweep and A
    assembly: none of their phases runs, and no stamp holds a reference."""
    from pyimcom_tpu_torch.coadd import Block

    cfg, out = _cfg(small_survey, "_nqc_phases", stop=2, LAKERNEL="Empirical",
                    EMPIRNQC=True)
    blk = Block(cfg=cfg, this_sub=1, device="cpu")
    phases = blk.phase_times()
    assert "stamp.solve" in phases and len(blk.stamp_stats) == 2
    for name in ("psf.sample_group", "psf.overlap", "stamp.plan", "stamp.sweep",
                 "stamp.assembleA"):
        assert name not in phases, name
    assert not blk._submat_ref and not blk._dev_submat and not blk._grp_cache
    assert all(s["uc_median"] == 0.0 and s["sigma_median"] == 0.0 for s in blk.stamp_stats)


def test_finalize_unreached_pixel_matches_host_path():
    """solve_finalize without quality control on a stamp with an output
    pixel out of every input's reach: the maps the reference's host path
    makes (coadd.py _output_stamp: T·data and Tsum NaN there, Neff 0 by
    nan_to_num, kappa, Sigma and U/C 0), the fade applied."""
    from pyimcom_tpu_torch.ops.assemble import solve_finalize

    rng = np.random.default_rng(3)
    m, n, nf, n_img, rho = 16, 40, 2, 3, 6.0
    dist = rng.uniform(0.0, 9.0, (m, n))
    dist[5] = 20.0
    data = rng.normal(size=(nf, n))
    img = rng.integers(0, n_img, n)
    onehot = np.eye(n_img)[img]
    fade = rng.uniform(0.5, 1.0, m)
    out = solve_finalize(None, None, *from_numpy([np.array([0.1]), np.array([5e-4]), data,
                                                  onehot, fade], CPU),
                         torch.zeros((1, 1), dtype=torch.bool), 1e-6, 0.5, 1e-3, 25,
                         "empirical", dist=torch.as_tensor(dist), rho_acc=rho,
                         no_qlt_ctrl=True)
    # the host path, in NumPy
    T = np.maximum(rho - dist, 0.0)
    with np.errstate(invalid="ignore"):
        T = (T / T.sum(axis=-1, keepdims=True))[None] * fade[None, :, None]
        Tsum_image = np.stack([T[:, :, img == i].sum(axis=2) for i in range(n_img)], axis=2)
        Neff = np.nan_to_num(1.0 / np.square(
            Tsum_image / np.abs(Tsum_image).sum(axis=2)[:, :, None]).sum(axis=2))
    want = {"outimage": np.einsum("oaj,ij->oia", T, data),
            "Tsum_inpix": Tsum_image.sum(axis=2), "Neff": Neff * fade,
            "Tsum_stamp": Tsum_image.sum(axis=1) / 25}
    for k, w in want.items():
        np.testing.assert_allclose(out[k].numpy(), w.astype(np.float32), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    assert np.isnan(out["outimage"].numpy()[:, :, 5]).all() and out["Neff"][0, 5] == 0.0
    for k in ("kappa", "Sigma", "UC"):
        assert out[k].abs().max() == 0.0
