"""
Device check and dtype policy of the port.

Everything runs in float64: the overlap spectra (cuFFT), the sweep values
(the hand-written D5512 kernels), A and -B/2, and the Cholesky solves
(cuSOLVER).  The JAX package assembles in f32 on accelerators only because
the TPU has no complex128 and no f64 matrix unit; the H100 runs f64 natively,
so the port is held to the CPU reference at the f64 bound.
"""

from __future__ import annotations

import torch

DTYPE = torch.float64

# TF32 keeps ~3 decimal digits: float32 matmuls and cuDNN convolutions must
# never silently drop to it (PyTorch enables it for cuDNN by default).  The
# port computes in float64, where TF32 does not apply; these settings keep
# any float32 product that a later change adds at full precision too.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """A torch.device for `device` ("cuda", "cuda:0", "cpu", ...).

    Asking for CUDA without a usable GPU raises: the port never carries on
    on the CPU when it was asked for the card.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but no CUDA GPU "
                               f"is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
