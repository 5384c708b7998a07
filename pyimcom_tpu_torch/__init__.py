"""
pyimcom_tpu_torch: the IMCOM block coadd on PyTorch and CUDA.

The port of ``pyimcom_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.
``pyimcom_tpu`` stays the reference: each module here keeps the name and the
public function names of its counterpart there, and the tests in
``tests/test_torch_*.py`` run both packages on the same inputs.

This package imports ``torch`` and never ``jax``, and nothing of
``pyimcom_tpu``.  It keeps its own copies of the reference's host modules
(``config``, ``fitsio``, ``wcsutil``, ``sphere``, ``asdfio``, ``profiling``,
``ops/psfmodels``, ``utils/moments``, ``utils/compareutils``, the layer
helpers in ``layer_host``, ``imdestripe``'s host helpers, ``compress``,
``truthcats`` and ``analysis``), which ``tests/test_torch_hostio.py`` holds
to their originals.  The TPU kernel on the coadd's path, the
D5512 interpolation, is a hand-written CUDA kernel pair for Hopper
(``csrc/interp_d5512.cu``); the destriper's bilinear gather and its
adjoint, which the JAX package leaves to XLA, are a hand-written CUDA pair
too (``csrc/bilinear.cu``); the relay's compile probe is a hand-written
build-and-launch probe (``csrc/probe.cu``, ``python -m
pyimcom_tpu_torch.probe``).  Both are built with ``nvcc`` at first use.

Modules:
    device      device check and the float64 policy
    convert     reference arrays -> port tensors
    ops         interpolation, CUDA kernels, Fourier overlaps, assembly,
                the destriping bilinear pair and cost
    psfgrp      PSF groups and overlap stacks
    solvers     Cholesky (any kappa nodes), Eigen, Iterative, Empirical
    layer       input layer cubes, star and galaxy injection
    coadd       the block coadd (``Block(cfg, this_sub, device=...)``)
    imdestripe  destriping (``main(cfg, device=...)``)
    layer_wrapper  the layer caches of every exposure, compression of a run
    compress    I24 layer compression and the transparent block reader
    analysis    block readers, the mosaic's halo exchange, noise and stars
    truthcats   truth catalogs of the injected sources
    bench       the benchmark line
    runner      blocks of a mosaic (``--share-pads``: the halo exchange)
    pipeline    the chained mosaic from destripe to compressed blocks
    probe       the toolchain probe of the card
"""

__version__ = "0.1.0"
