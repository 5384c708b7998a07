"""
Host helpers of the output maps, shared by the block coadd and the halo
exchange: the trapezoid cross-fade and the log quantization of a map (the
reference keeps both in pyimcom_tpu/coadd.py).  NumPy only, so that the
mosaic's post-passes (analysis.Mosaic, compression) never import torch.
"""

from __future__ import annotations

import numpy as np


def trapezoid(arr, fade_kernel, recover_mode=False, pad_widths=(0, 0, 0, 0),
              do_sides="BTLR", use_trunc_sinc=True):
    """
    In-place trapezoid cross-fade over 2*fade_kernel transition rows/columns
    on each requested side (reference OutStamp.trapezoid, coadd.py:1221-1292).
    """
    fk2 = fade_kernel * 2
    if fk2 <= 0:
        return
    ny, nx = arr.shape[-2:]
    pb, pt, pl, pr = pad_widths
    it, ir = ny - pt - 1, nx - pr - 1

    s = np.arange(1, fk2 + 1, dtype=np.float64) / (fk2 + 1)
    if use_trunc_sinc:
        s -= np.sin(2 * np.pi * s) / (2 * np.pi)
    sT = s[:, None]

    if not recover_mode:
        if "B" in do_sides:
            arr[..., pb:pb + fk2, :] *= sT
        if "T" in do_sides:
            arr[..., it:it - fk2 if it - fk2 >= 0 else None:-1, :] *= sT
        if "L" in do_sides:
            arr[..., :, pl:pl + fk2] *= s
        if "R" in do_sides:
            arr[..., :, ir:ir - fk2 if ir - fk2 >= 0 else None:-1] *= s
    else:
        if "B" in do_sides:
            arr[..., pb:pb + fk2, :] /= sT
        if "T" in do_sides:
            arr[..., it:it - fk2 if it - fk2 >= 0 else None:-1, :] /= sT
        if "L" in do_sides:
            arr[..., :, pl:pl + fk2] /= s
        if "R" in do_sides:
            arr[..., :, ir:ir - fk2 if ir - fk2 >= 0 else None:-1] /= s


def compress_map(map_, coef, dtype):
    """Log-quantize a float map to (u)int16 (reference coadd.py:2086-2138)."""
    if dtype == np.uint16:
        a_min, a_max = 0, 65535
    else:
        a_min, a_max = -32768, 32767
    return np.clip(np.floor(coef * np.log10(np.clip(map_, 1e-32, None)) + 0.5),
                   a_min, a_max).astype(dtype)
