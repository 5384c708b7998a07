"""Lossy+lossless layer compression of coadded block files.

The port's copy of ``pyimcom_tpu/compress/__init__.py``, so that the port
imports nothing of the JAX package; keep the two in step.
"""

from .compressutils import CompressedOutput, ReadFile  # noqa: F401
from .i24 import i24compress, i24decompress  # noqa: F401
