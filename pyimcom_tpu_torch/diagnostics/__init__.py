"""Validation report generation for coadded mosaics.

The port's copy of ``pyimcom_tpu/diagnostics/__init__.py``, so that the port imports
nothing of the JAX package; keep the two in step.
"""

from .report import ReportSection, ValidationReport  # noqa: F401
