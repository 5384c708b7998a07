"""pyimcom_tpu_torch stands alone: it never imports jax, and it imports
nothing of the JAX package pyimcom_tpu (nor of the JAX-side test fixture
survey_fixture), not even modules there that are jax-free; it keeps its
own copies.  The same holds for chip_smoke.py, k4_variants.py and
survey_fixture_torch."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import pyimcom_tpu_torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "pyimcom_tpu_torch"

MODULES = ("pyimcom_tpu_torch", "pyimcom_tpu_torch.coadd",
           "pyimcom_tpu_torch.ops.interp_cuda", "pyimcom_tpu_torch.ops.assemble",
           "pyimcom_tpu_torch.solvers", "pyimcom_tpu_torch.layer",
           "pyimcom_tpu_torch.probe", "pyimcom_tpu_torch.imdestripe",
           "pyimcom_tpu_torch.ops.bilinear", "pyimcom_tpu_torch.ops.bilinear_cuda",
           "pyimcom_tpu_torch.ops.destripe_device", "pyimcom_tpu_torch.utils.compareutils",
           "pyimcom_tpu_torch.bench", "pyimcom_tpu_torch.runner",
           "pyimcom_tpu_torch.compress", "pyimcom_tpu_torch.truthcats",
           "pyimcom_tpu_torch.analysis", "pyimcom_tpu_torch.layer_wrapper",
           "pyimcom_tpu_torch.pipeline", "pyimcom_tpu_torch.outmaps",
           "pyimcom_tpu_torch.splitpsf", "pyimcom_tpu_torch.splitpsf.splitpsf",
           "pyimcom_tpu_torch.splitpsf.imsubtract", "pyimcom_tpu_torch.splitpsf.update_cube",
           "pyimcom_tpu_torch.utils.piffutils", "pyimcom_tpu_torch.meta",
           "pyimcom_tpu_torch.meta.ginterp", "pyimcom_tpu_torch.meta.distortimage",
           "pyimcom_tpu_torch.diagnostics", "pyimcom_tpu_torch.diagnostics.run",
           "pyimcom_tpu_torch.diagnostics.sections", "pyimcom_tpu_torch.diagnostics.stability",
           "pyimcom_tpu_torch.diagnostics.starsdata", "pyimcom_tpu_torch.pictures",
           "pyimcom_tpu_torch.pictures.genpic")

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


def _sources():
    """Every .py of the port (not its git-ignored build directory), the
    chip smoke script, the K4 variant timer and the port's survey fixture."""
    port = [p for p in sorted(PKG.rglob("*.py"))
            if "_build" not in p.relative_to(PKG).parts[:-1]]
    return port + [REPO / "chip_smoke.py", REPO / "k4_variants.py",
                   REPO / "tests" / "survey_fixture_torch.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("pyimcom_tpu", "survey_fixture", "jax")


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_names_the_jax_package(path):
    """An AST scan: no `import` or absolute `from` statement, at any depth
    (functions included), names pyimcom_tpu, survey_fixture or jax."""
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            bad += [(node.lineno, a.name) for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append((node.lineno, node.module))
    assert not bad, f"{path.name} imports {bad}"


def _port_modules():
    return ["pyimcom_tpu_torch"] + sorted(
        m.name for m in pkgutil.walk_packages(pyimcom_tpu_torch.__path__, "pyimcom_tpu_torch."))


def test_every_port_module_imports_with_the_jax_package_unimportable():
    """pyimcom_tpu, survey_fixture and jax made unimportable: every module of
    the port and survey_fixture_torch still import."""
    mods = _port_modules() + ["survey_fixture_torch"]
    assert len(mods) > 20
    code = ("import importlib, sys\n"
            "for name in ('pyimcom_tpu', 'survey_fixture', 'jax'):\n"
            "    sys.modules[name] = None\n"
            f"sys.path.insert(0, {str(REPO / 'tests')!r})\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert sys.modules['pyimcom_tpu'] is None\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
