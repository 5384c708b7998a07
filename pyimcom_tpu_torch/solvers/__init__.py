"""Linear-algebra kernels producing the coaddition matrix T and quality maps."""

from .kernels import cholesky_solve  # noqa: F401
