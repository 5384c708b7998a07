"""Linear-algebra kernels producing the coaddition matrix T and quality maps."""

from .kernels import (  # noqa: F401
    KERNELS,
    cholesky_solve,
    cholesky_solve_mixed,
    eigen_solve,
    empirical_weights,
    iterative_solve,
)
