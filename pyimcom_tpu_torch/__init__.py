"""
pyimcom_tpu_torch: the IMCOM block coadd on PyTorch and CUDA.

The port of ``pyimcom_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.
``pyimcom_tpu`` stays the reference: each module here keeps the name and the
public function names of its counterpart there, and the tests in
``tests/test_torch_*.py`` run both packages on the same inputs.

This package imports ``torch`` and never ``jax``.  Its jax-free host pieces
(configuration, FITS, WCS, PSF models, the sphere grid, layer helpers) are
imported from ``pyimcom_tpu``.  The one TPU kernel on the coadd's path, the
D5512 interpolation, is a hand-written CUDA kernel pair for Hopper
(``csrc/interp_d5512.cu``), built with ``nvcc`` at first use.

Modules:
    device      device check and the float64 policy
    convert     reference arrays -> port tensors
    ops         interpolation, CUDA kernels, Fourier overlaps, assembly
    psfgrp      PSF groups and overlap stacks
    solvers     single-kappa Cholesky solve
    layer       input layer cubes and star injection
    coadd       the block coadd (``Block(cfg, this_sub, device=...)``)
"""

__version__ = "0.1.0"
