"""X7: the port's stereographic device projection, stg_projection_torch,
against the JAX package's stg_projection_jax (x64, CPU) and the port's host
WCS.

Two projections: tests/test_wcs.py's block WCS (CTR 60.0504, -3.8, LONPOLE
240, 0.04" a pixel), and one at LONPOLE 180 centred at a declination of
+-80 degrees and RA 0.005 at the production output scale (0.0390625" a
pixel), whose points cross RA 0/360.  The points are seeded with NumPy.
The two closed forms compute the same terms, so they agree to 1e-12 deg in
(ra, dec), ra compared as an angle, and to 1e-10 px in (x, y) on the block
WCS.  torch and XLA differ by up to one ulp in sin, cos, atan2 and hypot,
and world2pix divides its angles' rounding by the pixel scale in radians:
at +-80 degrees, where its terms cancel more, a one-ulp difference reaches
1.6e-10 px (the JAX form's own round trip is off by 1.5e-9 px there), so
the polar cases' (x, y) are held to one float64 epsilon over the pixel
scale in radians (pix_tol, 1.2e-9 px).  The round trip and
the host WCS are held to test_wcs.py's bounds (1e-10 deg, 1e-8 px).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyimcom_tpu.config as ref_config
import pyimcom_tpu.wcsutil as ref_wcsutil
from pyimcom_tpu_torch import config, wcsutil

torch.set_num_threads(1)
MINI_CFG = {
    "OBSFILE": "x", "INDATA": ["x", "L2_2506"], "CTR": [60.0504, -3.8],
    "LONPOLE": 240.0, "OUTSIZE": [4, 25, 0.04], "BLOCK": 2, "FILTER": 1,
    "INPSF": ["x", "L2_2506", 6], "OUT": "/tmp/x", "FADE": 1, "PAD": 0,
}
POLAR_SCALE = 0.0390625 / 3600              # degrees a pixel


def pix_tol(scale_deg):
    """The bound on (x, y) between two forms of the closed form at a pixel
    scale of `scale_deg` degrees: one float64 epsilon of an angle over the
    scale in radians (at least 1e-10 px)."""
    return max(1e-10, np.finfo(np.float64).eps / np.deg2rad(scale_deg))


def _projection(case):
    """(crval, crpix, cdelt, lonpole), the port's host WCS of it, and the
    pixel range of the points."""
    if case == "block":
        cfg = config.Config(dict(MINI_CFG))
        w = wcsutil.make_block_wcs(cfg, 1, 0)
        ref = ref_wcsutil.make_block_wcs(ref_config.Config(dict(MINI_CFG)), 1, 0)
        assert tuple(ref.crpix) == tuple(w.crpix)
        return ((cfg.ra, cfg.dec), tuple(w.crpix), (-cfg.dtheta, cfg.dtheta), cfg.lonpole,
                w, (0.0, 100.0))
    dec = 80.0 if case == "north80" else -80.0
    crval, crpix, cdelt = (0.005, dec), (2043.5, 2043.5), (-POLAR_SCALE, POLAR_SCALE)
    w = wcsutil.WCS(ctype=("RA---STG", "DEC--STG"), crval=crval, crpix=crpix,
                    cd=np.diag(cdelt), lonpole=180.0)
    return crval, crpix, cdelt, 180.0, w, (0.0, 4088.0)


def _angle(a, b):
    """|a - b| in degrees, as angles (across the 0 / 360 wrap)."""
    return np.abs((np.asarray(a) - np.asarray(b) + 180.0) % 360.0 - 180.0)


@pytest.mark.parametrize("case", ["block", "north80", "south80"])
def test_stg_torch_matches_jax_and_host(case):
    """pix2world and world2pix against stg_projection_jax on the same
    points, the round trip, and the port's host WCS.pix2world."""
    crval, crpix, cdelt, lonpole, w, (lo, hi) = _projection(case)
    rng = np.random.default_rng(16)
    x, y = rng.uniform(lo, hi, (2, 4096))
    p2w, w2p = wcsutil.stg_projection_torch(crval, crpix, cdelt, lonpole)
    ref_p2w, ref_w2p = ref_wcsutil.stg_projection_jax(crval, crpix, cdelt, lonpole)

    ra, dec = (t.numpy() for t in p2w(torch.as_tensor(x), torch.as_tensor(y)))
    ra_j, dec_j = (np.asarray(a) for a in ref_p2w(jnp.asarray(x), jnp.asarray(y)))
    assert ra.dtype == dec.dtype == np.float64
    assert np.all((ra >= 0) & (ra < 360))
    if case != "block":
        assert ra.min() < 1 and ra.max() > 359           # the points cross RA 0 / 360
    assert _angle(ra, ra_j).max() < 1e-12 and np.abs(dec - dec_j).max() < 1e-12

    x2, y2 = (t.numpy() for t in w2p(torch.as_tensor(ra), torch.as_tensor(dec)))
    x2_j, y2_j = (np.asarray(a) for a in ref_w2p(jnp.asarray(ra), jnp.asarray(dec)))
    tol = 1e-10 if case == "block" else pix_tol(abs(cdelt[0]))
    assert np.abs(x2 - x2_j).max() < tol and np.abs(y2 - y2_j).max() < tol
    assert np.abs(x2 - x).max() < 1e-8 and np.abs(y2 - y).max() < 1e-8

    ra_h, dec_h = w.pix2world(x, y)
    assert _angle(ra, ra_h).max() < 1e-10 and np.abs(dec - dec_h).max() < 1e-10


def test_stg_torch_keeps_shape():
    """The maps keep their inputs' shape: a (3, 5, 7) batch gives the flat
    batch's values bit for bit, and its round trip within 1e-8 px."""
    crval, crpix, cdelt, lonpole, _w, _r = _projection("block")
    p2w, w2p = wcsutil.stg_projection_torch(crval, crpix, cdelt, lonpole)
    rng = np.random.default_rng(17)
    x, y = (torch.as_tensor(a) for a in rng.uniform(0, 100, (2, 3, 5, 7)))
    ra, dec = p2w(x, y)
    assert ra.shape == dec.shape == (3, 5, 7)
    flat_ra, flat_dec = p2w(x.reshape(-1), y.reshape(-1))
    assert torch.equal(ra.reshape(-1), flat_ra) and torch.equal(dec.reshape(-1), flat_dec)
    xb, yb = w2p(ra, dec)
    assert xb.shape == yb.shape == (3, 5, 7)
    assert float((xb - x).abs().max()) < 1e-8 and float((yb - y).abs().max()) < 1e-8
