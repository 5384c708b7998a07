"""Several devices for one block: pyimcom_tpu_torch.parallel.mesh and the
banded Block against the JAX package's mesh and the port's one-device
block, on the CPU.

The JAX functions run on make_mesh(4) of the 8 virtual CPU devices that
tests/conftest.py asks for; the port's on ["cpu"] * 4, the same code path
as four cards (a list that repeats a device runs the banded path).  Bounds:
sharded_stamp_solve's T equals the port's one-device Cholesky solve of each
stamp within 1e-12 of its scale (the mesh adds no arithmetic), and the JAX
mesh's T within 1e-12 of its scale (statistics rtol 1e-12) on
well-conditioned seeded systems; on __graft_entry__._example_system
(a Gaussian overlap plus 1e-8 I, condition ~1e6 at the nodes), which puts
the two packages' LAPACK and XLA factorizations ~1e-11 of scale apart,
within the port's Cholesky parity bounds of tests/test_torch_solvers.py:
1e-10 at one kappa node, 1e-9 at three (the held multi-kappa divergence),
statistics rtol 1e-10 (Sigma_max ~700 agrees to ~2e-12).
solve_finalize_mesh's float32 maps as
tests/test_torch_assemble.py holds solve_finalize (1e-6 of scale, U/C to
atol 1e-12) and its statistics, reduced from those float32 maps, to rtol
1e-6.

The banded blocks run on the reduced survey of tests/test_torch_block.py
at STOP 8 (one row of two 2x2 groups, so a round holds one group a band and
the band seam between them is recomputed) on ["cpu"] * 2 and ["cpu"] * 4
against ["cpu"], as
tests/test_device_assembly.py::test_multi_device_rounds_match_single_device
runs the JAX package's: the science cube within 1e-12 of its scale, the maps
to 1 LSB, INWEIGHT to 1e-8 (_compare_outputs), no cross-device pool reuse,
the round statistics set.  The 2-band run snapshots after every drained
group; its first snapshot, put back, resumes the block under bands.  The
block is the survey's one centred block (BLOCK 1) of 4 x 4 stamps of 14
pixels (~210 input pixels a stamp), not its block 1 of 25-pixel stamps: the
plain sweep of a 25-pixel STOP-8 block takes ~40 s on one CPU thread, four
of which the Tier-1 clock cannot take; the bench block at full size runs
banded on the card (chip_smoke.py's multi_device).  No JAX Block runs here:
the one-device port block is held to the reference by
tests/test_torch_block.py and tests/test_torch_multigroup.py.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from __graft_entry__ import _example_system
from test_device_assembly import _compare_outputs
from test_torch_assemble import _compare_maps
from test_torch_block import small_survey  # noqa: F401

from pyimcom_tpu.parallel import mesh as ref_mesh
from pyimcom_tpu_torch.parallel import mesh

torch.set_num_threads(1)
CPU4 = [torch.device("cpu")] * 4


def _well_conditioned(S, n, m, n_out, nv, seed=11):
    """S seeded systems A = X X^T / 40 + 1e-3 I (condition ~1e3), -B/2 and
    the kappa nodes of tests/test_torch_assemble.py's _solve_case."""
    rng = np.random.default_rng(seed)
    A = np.stack([X @ X.T / 40 + 1e-3 * np.eye(n)
                  for X in rng.standard_normal((S, n, 40))])
    mB = rng.standard_normal((S, n_out, m, n)) * 0.3
    return A, mB, np.array([1.5]), np.array([5e-4, 1e-3, 2e-3][:nv])


def _example_systems(S, n, m, n_out, nv):
    systems = [_example_system(n=n, m=m, n_out=n_out, nv=nv, seed=s) for s in range(S)]
    return (np.stack([s[0] for s in systems]), np.stack([s[1] for s in systems]),
            systems[0][2], systems[0][3])


# (systems, kappa nodes, the bound on T against the JAX mesh, on the stats)
SHARDED = {"well-conditioned": (_well_conditioned, 1, 1e-12, 1e-12),
           "example-one-node": (_example_systems, 1, 1e-10, 1e-10),
           "example-three-nodes": (_example_systems, 3, 1e-9, 1e-10)}


@pytest.mark.parametrize("case", list(SHARDED))
def test_sharded_stamp_solve_matches_jax(case):
    from pyimcom_tpu_torch.solvers import cholesky_solve

    make, nv, bound, st_bound = SHARDED[case]
    S, n, m, n_out = 8, 64, 16, 1
    A, mB, C, kappaC = make(S, n, m, n_out, nv)
    T_ref, st_ref = ref_mesh.sharded_stamp_solve(ref_mesh.make_mesh(4), A, mB, C, kappaC,
                                                 1e-6, 0.5)
    T, st = mesh.sharded_stamp_solve(CPU4, A, mB, C, kappaC, 1e-6, 0.5)
    T_ref = np.asarray(T_ref)
    assert T.shape == T_ref.shape == (S, n_out, m, n)
    T_one = torch.stack([cholesky_solve(*(torch.as_tensor(a) for a in (A[s], mB[s], C, kappaC)),
                                        1e-6, 0.5)[0] for s in range(S)])
    assert float((T - T_one).abs().max()) <= 1e-12 * float(T_one.abs().max())
    assert np.abs(T.numpy() - T_ref).max() <= bound * np.abs(T_ref).max()
    assert st.keys() == st_ref.keys()
    for k in st:
        np.testing.assert_allclose(st[k], st_ref[k], rtol=st_bound, err_msg=k)
    with pytest.raises(ValueError, match="divide"):
        mesh.sharded_stamp_solve(CPU4[:3], A, mB, C, kappaC, 1e-6, 0.5)


def _round_case(D=4, S=2, n=96, m=25, n_out=1, nfr=2, nimg=3):
    """D groups of S seeded stamp systems (tests/test_torch_assemble.py's
    _solve_case, D * S stamps)."""
    rng = np.random.default_rng(12)
    A = np.zeros((D * S, n, n))
    for s in range(D * S):
        X = rng.standard_normal((n, 40))
        A[s] = X @ X.T / 40 + 1e-3 * np.eye(n)
    B = rng.standard_normal((D * S, n_out, m, n)) * 0.3
    data = rng.standard_normal((D * S, nfr, n)).astype(np.float32)
    onehot = np.zeros((D * S, n, nimg), np.float32)
    for s in range(D * S):
        onehot[s, np.arange(n), rng.integers(0, nimg, n)] = 1.0
    fade = rng.uniform(0.5, 1.0, m)
    return A, B, np.array([1.5]), np.array([5e-4]), data, onehot, fade


def test_solve_finalize_mesh_matches_jax():
    D, S = 4, 2
    A, B, C, kC, data, onehot, fade = _round_case(D, S)
    args = (1e-6, 0.5, 1e-3, 25, "monolithic", False, 30)
    jm = ref_mesh.make_mesh(D)
    sh = NamedSharding(jm, P(jm.axis_names[0]))
    put = [jax.device_put(jnp.asarray(a), sh) for a in
           (A, B, data, onehot, np.zeros((D * S, 1, 1), bool))]
    want, st_ref = ref_mesh.solve_finalize_mesh(jm, put[0], put[1], jnp.asarray(C),
                                                jnp.asarray(kC), put[2], put[3],
                                                jnp.asarray(fade), put[4], *args)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64)

    parts = [dict(A=t(A[k * S:(k + 1) * S]), mBhalf=t(B[k * S:(k + 1) * S]), C=t(C),
                  kappaC=t(kC), data=t(data[k * S:(k + 1) * S]),
                  img_onehot=t(onehot[k * S:(k + 1) * S]), fade=t(fade),
                  relevant=torch.zeros((S, 1, 1), dtype=torch.bool), dist=None)
             for k in range(D)]
    outs, partials = mesh.solve_finalize_mesh(CPU4, parts, *args)
    assert len(outs) == len(partials) == D and all(p.shape == (3,) for p in partials)
    got = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
    _compare_maps(got, want)
    st = mesh.reduce_stats(partials)
    for k in ("uc_max", "sigma_max", "sigma_sum"):
        np.testing.assert_allclose(st[k], float(st_ref[k]), rtol=1e-6, err_msg=k)


def test_make_mesh():
    cpu = torch.device("cpu")
    assert mesh.make_mesh(3, "cpu") == [cpu] * 3
    assert mesh.make_mesh(None, "cpu") == [cpu]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh.make_mesh(2)


# --------------------------------------------------------------------------
# the banded block
# --------------------------------------------------------------------------

# the banded blocks' geometry: one centred block of 4 x 4 stamps of 14 px
BANDED = dict(BLOCK=1, OUTSIZE=[4, 14, 0.04])


def _banded_cfg(cfg_dict, suffix):
    """(Config, output path) of the banded tests' block at STOP 8."""
    from pyimcom_tpu_torch.config import Config

    d = dict(cfg_dict, STOP=8, **BANDED)
    d["OUT"] = d["OUT"] + suffix
    return Config(d), d["OUT"] + "_00_00.fits"


@pytest.fixture(scope="module")
def banded(small_survey):  # noqa: F811
    """The block at STOP 8 on ["cpu"], on ["cpu"] * 2 with a snapshot after
    every drained group (the first kept aside), on ["cpu"] * 4, then the
    2-band block resumed from that first snapshot."""
    from pyimcom_tpu_torch.coadd import Block

    def run(n, **kw):
        cfg, out = _banded_cfg(small_survey, f"_band{n}")
        return Block(cfg=cfg, this_sub=0, devices=["cpu"] * n, **kw), out

    runs = {1: run(1), 4: run(4)}
    out2 = _banded_cfg(small_survey, "_band2")[1]
    ckpt = out2[:-len(".fits")] + ".ckpt.npz"
    first = ckpt + ".first.npz"
    orig = Block._maybe_ckpt

    def keep_first(self):
        orig(self)
        if os.path.exists(ckpt) and not os.path.exists(first):
            shutil.copy(ckpt, first)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Block, "_maybe_ckpt", keep_first)
        blk2, _ = run(2, checkpoint_sec=0)
    # the 2-band block again, from its first snapshot
    done = out2[:-len(".fits")] + "_whole.fits"
    os.replace(out2, done)
    runs[2] = (blk2, done)
    shutil.copy(first, ckpt)
    runs["resumed"] = run(2, checkpoint_sec=0)
    runs["snapshot"] = ckpt
    return runs


@pytest.mark.parametrize("n", [2, 4])
def test_banded_block_matches_single_device(banded, n):
    one, out1 = banded[1]
    blk, out = banded[n]
    assert blk.devices == [torch.device("cpu")] * n and len(one.devices) == 1
    assert len(blk.stamp_stats) == len(one.stamp_stats) == 8
    _compare_outputs(out1, out, atol_sci=1e-12)
    assert blk._cross_device_puts == 0
    st = blk._round_stats
    assert st is not None and one._round_stats is None
    assert 0 < st["uc_max"] and 0 < st["sigma_max"] <= st["sigma_sum"]
    # the seam between the two bands' groups was recomputed, not copied
    assert blk.pool_stats["recomputed"] > 0 == one.pool_stats["recomputed"]


def test_banded_block_resumes_from_a_checkpoint(banded, capfd):
    one, out1 = banded[1]
    blk, out = banded["resumed"]
    assert blk._ckpt_base == 1 and len(blk.stamp_stats) == 4
    assert not os.path.exists(banded["snapshot"]), "the finished block removes the snapshot"
    assert blk._cross_device_puts == 0
    _compare_outputs(out1, out, atol_sci=1e-12)


def test_runner_passes_devices(small_survey, monkeypatch):  # noqa: F811
    """runner --devices N gives each block make_mesh(N, --device)."""
    import json

    from pyimcom_tpu_torch import coadd, runner

    seen = []

    class Recorder:
        def __init__(self, **kw):
            seen.append(kw)

    monkeypatch.setattr(coadd, "Block", Recorder)
    d = dict(small_survey, OUT=small_survey["OUT"] + "_rdev")
    cfg_path = os.path.join(os.path.dirname(small_survey["OUT"]), "cfg_rdev.json")
    with open(cfg_path, "w") as f:
        json.dump(d, f)
    assert runner.main([cfg_path, "--block", "1", "--device", "cpu", "--devices", "3"]) == 0
    assert runner.main([cfg_path, "--block", "1", "--device", "cpu"]) == 0
    assert seen[0]["devices"] == [torch.device("cpu")] * 3 and seen[0]["device"] == "cpu"
    assert "devices" not in seen[1]
