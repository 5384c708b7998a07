"""PSF wing splitting and subtraction (iterative bright-wing correction):
``splitpsf`` (host copy), ``imsubtract`` (the wing subtraction on the
device: G4460 resample, cuFFT convolution) and ``update_cube`` (host copy)."""

from .splitpsf import SplitPSF, split_psf_to_fits  # noqa: F401
from .update_cube import update as update_cube  # noqa: F401
