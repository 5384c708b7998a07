"""Mosaic picture generation.

The port's copy of ``pyimcom_tpu/pictures/__init__.py``, so that the port imports
nothing of the JAX package; keep the two in step.
"""

from .genpic import cmapscale, make_picture_1band  # noqa: F401
