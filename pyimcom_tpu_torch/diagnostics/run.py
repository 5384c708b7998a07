"""
Report driver: ``python -m pyimcom_tpu_torch.diagnostics.run <block.fits> <outstem>``
(counterpart of reference diagnostics/run.py).

The port's copy of ``pyimcom_tpu/diagnostics/run.py``, so that the port imports
nothing of the JAX package; keep the two in step.
"""

from __future__ import annotations

import sys

from .report import ValidationReport
from .sections import (DynamicRange, LayerReport, MosaicImage, RowStability,
                       NoiseReport, SimulatedStar, StarCube)


def run_report(fname, outstem, clear_all: bool = True,
               star_layer: str = "cstar14", ds_dir: str = None,
               ds_pattern: str = None) -> str:
    """Build the standard validation report; returns the PDF path.

    ds_dir : optional directory of destriped exposures for the
    row-stability section (reference diagnostics/noise/stability.py).
    ds_pattern : optional filename regex for that section.
    """
    rpt = ValidationReport(fname, outstem, clear_all=clear_all)
    for cls in [MosaicImage, LayerReport, NoiseReport, DynamicRange,
                StarCube]:
        s = cls(rpt)
        s.build()
        rpt.addsections([s])
    s = SimulatedStar(rpt, layer=star_layer)
    s.build()
    rpt.addsections([s])
    kw = {"pattern": ds_pattern} if ds_pattern else {}
    s = RowStability(rpt, directory=ds_dir, **kw)
    s.build()
    rpt.addsections([s])
    return rpt.compile()


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print("usage: python -m pyimcom_tpu_torch.diagnostics.run <block.fits> <outstem>")
        return 1
    ds_dir = argv[2] if len(argv) > 2 else None
    pdf = run_report(argv[0], argv[1], ds_dir=ds_dir)
    print("report written to", pdf)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
