"""
Jax-free twin of survey_fixture.py: the same synthetic miniature survey,
with the star images drawn by pyimcom_tpu_torch's grid interpolation.

survey_fixture.py imports jax only inside its draw_star; every other piece
of it is used here unchanged.  build_survey is survey_fixture.build_survey's
own code, bound to a namespace whose draw_star is the one below.
"""

import types

import numpy as np
import torch

import survey_fixture

from pyimcom_tpu_torch.ops.interp import grid_interp


def draw_star(psf_tophat, xstar, ystar, nside, ov, window=80):
    """
    Unit-flux star image: resample the tophat-convolved oversampled PSF onto
    the native pixel grid around (xstar, ystar), in float64 on the CPU.
    """
    ns_psf = psf_tophat.shape[0]
    ctr = (ns_psf - 1) / 2.0
    im = np.zeros((nside, nside), dtype=np.float32)
    x0 = max(0, int(xstar) - window)
    x1 = min(nside, int(xstar) + window)
    y0 = max(0, int(ystar) - window)
    y1 = min(nside, int(ystar) + window)
    if x1 <= x0 or y1 <= y0:
        return im
    cpu = torch.device("cpu")
    qx = torch.as_tensor((ov * (np.arange(x0, x1) - xstar) + ctr)[None, :],
                         dtype=torch.float64, device=cpu)
    qy = torch.as_tensor((ov * (np.arange(y0, y1) - ystar) + ctr)[None, :],
                         dtype=torch.float64, device=cpu)
    img = torch.as_tensor(psf_tophat, dtype=torch.float64, device=cpu)
    im[y0:y1, x0:x1] = grid_interp(img, qx, qy)[0].numpy()
    return im


build_survey = types.FunctionType(
    survey_fixture.build_survey.__code__,
    {**vars(survey_fixture), "draw_star": draw_star},
    "build_survey", survey_fixture.build_survey.__defaults__)
