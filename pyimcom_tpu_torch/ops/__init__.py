"""Tensor operations of the port: interpolation (with its CUDA kernels),
Fourier overlaps and system-matrix assembly."""
