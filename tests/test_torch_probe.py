"""The port's build-and-launch probe (pyimcom_tpu_torch.probe) without a card:
it imports, its plain version adds 1.0, and asking it to probe a machine
without CUDA raises.  The kernel itself runs in tests/test_torch_cuda.py."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pyimcom_tpu_torch import probe

torch.set_num_threads(1)
REPO = str(Path(__file__).resolve().parents[1])


def test_plain_version_adds_one():
    x = torch.zeros((8, 128), dtype=torch.float32)
    probe.reset_launch_counts()
    y = probe.probe_add_one(x)
    assert y.dtype == torch.float32 and torch.equal(y, torch.ones_like(x))
    assert probe.launches["probe_add_one"] == 0     # no kernel on the CPU


def test_probe_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the probe runs in chip_smoke.py")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        probe.run()
    proc = subprocess.run([sys.executable, "-m", "pyimcom_tpu_torch.probe"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
