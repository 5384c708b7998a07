"""pyimcom_tpu_torch never imports jax, directly or through the reference
modules it uses."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REPO = str(Path(__file__).resolve().parents[1])

MODULES = ("pyimcom_tpu_torch", "pyimcom_tpu_torch.coadd",
           "pyimcom_tpu_torch.ops.interp_cuda")

CASES = {
    # jax made unimportable: every import must still succeed
    "blocked": "import sys; sys.modules['jax'] = None\n"
               "import {mods}\n"
               "assert sys.modules['jax'] is None\n",
    # jax importable: none of the port's imports pulls it in
    "untouched": "import sys\n"
                 "import {mods}\n"
                 "assert not [m for m in sys.modules if m.split('.')[0] == 'jax'], "
                 "sorted(m for m in sys.modules if 'jax' in m)\n",
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_imports_without_jax(case):
    code = CASES[case].format(mods=", ".join(MODULES))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
