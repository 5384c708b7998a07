"""Metadetection post-processing: analytic interpolation + sheared resampling
(the tap gather on a device)."""

from .distortimage import MetaMosaic, shearmosaic  # noqa: F401
from .ginterp import InterpMatrix, MultiInterp  # noqa: F401
