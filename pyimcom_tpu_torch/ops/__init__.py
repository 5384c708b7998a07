"""Tensor operations of the port: interpolation (with its CUDA kernels),
Fourier overlaps, system-matrix assembly, and the destriping bilinear pair
(with its CUDA kernels) and cost."""
