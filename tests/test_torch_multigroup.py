"""The port's whole reduced block, four groups, against the reference.

tests/test_torch_checkpoint.py and tests/test_torch_budget.py hold their
killed-and-resumed and budgeted runs to the port's own uninterrupted block 1
at STOP 0: four 2x2 groups over two group rows, whose submatrix pools are
kept from one row to the next.  This test holds that uninterrupted run to
the reference Block's device group engine (PYIMCOM_DEVICE_ASSEMBLY=1) on
the same configuration, at compare_outputs_f32's bounds, so the checkpoint
and budget results are held to the reference through it.  The reference
runs first, while another worker may still be making the shared
uninterrupted run.
"""

import torch

from test_torch_block import _cfg, compare_outputs_f32, small_survey  # noqa: F401
from test_torch_checkpoint import uninterrupted  # noqa: F401

torch.set_num_threads(1)


def test_whole_block_matches_reference(small_survey, monkeypatch, request):
    from pyimcom_tpu.coadd import Block as RefBlock

    monkeypatch.setenv("PYIMCOM_DEVICE_ASSEMBLY", "1")
    monkeypatch.setenv("PYIMCOM_NDEVICES", "1")
    cfg, out_ref = _cfg(small_survey, "_whole_ref", stop=0)
    ref = RefBlock(cfg=cfg, this_sub=1)
    assert ref.nrun == 16
    compare_outputs_f32(out_ref, request.getfixturevalue("uninterrupted"))
