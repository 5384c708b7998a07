"""
Fourier-domain PSF overlap engine in float64 ``torch.fft``.

Counterpart of pyimcom_tpu/ops/fourier.py and ops/dftmm.py.  The contract is
the JAX package's host f64 branch (pyimcom_tpu/psfgrp.py:142-152, :341-352,
:371-374): zero-pad each sampled PSF to the (nfft, nfft) frame, rfft2, form
the cross-power, irfft2, roll the zero lag to (nc, nc) and crop the novl
window.  On the card these are cuFFT transforms in complex128; the
DFT-by-matmul form of ops/dftmm.py existed only because the TPU has no
complex128, and is not ported.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def pad_and_rfft2(psf_arr: torch.Tensor, nfft: int) -> torch.Tensor:
    """(..., nsamp, nsamp) PSFs, corner-anchored in an (nfft, nfft) frame ->
    rfft2 spectra (..., nfft, nfft//2+1)."""
    nsamp = psf_arr.shape[-1]
    pad = F.pad(psf_arr, (0, nfft - nsamp, 0, nfft - nsamp))
    return torch.fft.rfft2(pad)


def overlap_from_rft(rft1: torch.Tensor, rft2: torch.Tensor,
                     nsamp_out: int, nfft: int) -> torch.Tensor:
    """Cross-correlation window (..., nsamp_out, nsamp_out) of two spectra,
    zero lag at the centre (nc, nc), nc = nsamp_out // 2:
        ovl[..., nc+dy, nc+dx] = sum_{y,x} psf1[y+dy, x+dx] * psf2[y, x]."""
    nc = nsamp_out // 2
    corr = torch.fft.irfft2(rft1 * torch.conj(rft2), s=(nfft, nfft))
    corr = torch.roll(corr, (nc, nc), dims=(-2, -1))
    return corr[..., :nsamp_out, :nsamp_out]


def zero_lag_from_rft(rft: torch.Tensor, nfft: int) -> torch.Tensor:
    """Zero-lag self-overlap of each spectrum (...,)."""
    return torch.fft.irfft2(rft * torch.conj(rft), s=(nfft, nfft))[..., 0, 0]


def apply_amp_penalty(rft: torch.Tensor, nfft: int, amp: float,
                      sigma_eff: float) -> torch.Tensor:
    """Re-weight the Fourier modes of PSF spectra by
    1 + amp * exp(-2 pi^2 u^2 sigma_eff^2); sigma_eff in samples."""
    u2 = torch.fft.fftfreq(nfft, dtype=torch.float64, device=rft.device) ** 2
    ut2 = u2[:, None] + u2[None, :nfft // 2 + 1]
    return rft * (1.0 + amp * torch.exp(-2.0 * math.pi ** 2 * ut2 * sigma_eff ** 2))
