"""The pool budget of pyimcom_tpu_torch.coadd.Block on the CPU.

The port's twin of
tests/test_device_assembly.py::test_pool_budget_eviction_matches_unbudgeted:
with a budget of 1 byte every pool but the newest is evicted after each
drained group, and the still-referenced submatrices are recomputed by the
next group's sweep; the whole block 1 of the reduced survey (cross-row
reuse) matches the unbudgeted run of test_torch_checkpoint.py within 1e-12
of the science cube's scale (the maps to 1 LSB, INWEIGHT to 1e-8).  The
eviction order is checked on its own: bytes per pool tensor, oldest round
first, never the newest.
"""

import numpy as np
import torch

from test_device_assembly import _compare_outputs
from test_torch_block import _cfg, small_survey  # noqa: F401
from test_torch_checkpoint import uninterrupted  # noqa: F401

torch.set_num_threads(1)


def test_pool_budget_eviction_matches_unbudgeted(small_survey, uninterrupted, capfd):
    from pyimcom_tpu_torch.coadd import Block

    cfg, out = _cfg(small_survey, "_budget", stop=0)
    blk = Block(cfg=cfg, this_sub=1, device="cpu", pool_budget_bytes=1)
    assert "pool budget: evicted" in capfd.readouterr().out
    st = blk.pool_stats
    assert st["budget_bytes"] == 1 and st["evictions"] >= 1 and st["recomputed"] >= 1
    assert len(st["retained"]) == 4 and st["peak_bytes"] == max(st["retained"])
    _compare_outputs(uninterrupted, out, atol_sci=1e-12)


def test_eviction_order():
    """Pools are counted once per tensor, evicted oldest first until the
    retained bytes fit, and the newest round is kept even over budget."""
    from pyimcom_tpu_torch.coadd import Block

    blk = Block.__new__(Block)
    pools = {r: torch.zeros(100 * r, dtype=torch.float64) for r in (1, 2, 3)}
    # key -> {band: pooled submatrix}: one band here
    blk._dev_submat = {("a", 1): {0: dict(pool=pools[1], round=1)},
                       ("b", 1): {0: dict(pool=pools[1], round=1)},
                       ("a", 2): {0: dict(pool=pools[2], round=2)},
                       ("a", 3): {0: dict(pool=pools[3], round=3)}}
    blk.pool_stats = dict(retained=[], peak_bytes=0, evictions=0, evicted_bytes=0)
    blk._pool_budget = 8 * (300 + 200)          # fits rounds 2 and 3, not 1
    blk._maybe_evict_pools()
    assert sorted(blk._dev_submat) == [("a", 2), ("a", 3)]
    assert blk.pool_stats["retained"] == [8 * 500] and blk.pool_stats["evictions"] == 1
    blk._pool_budget = 1
    blk._maybe_evict_pools()
    assert list(blk._dev_submat) == [("a", 3)]
    assert blk.pool_stats["retained"][-1] == 8 * 300
    assert blk.pool_stats["evicted_bytes"] == 8 * 300
    assert blk.pool_stats["peak_bytes"] == 8 * 500
    np.testing.assert_array_equal(blk._dev_submat[("a", 3)][0]["pool"].numpy(), 0.0)
