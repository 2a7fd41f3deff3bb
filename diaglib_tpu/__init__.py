"""diaglib-tpu: a matrix-free iterative eigensolver library in JAX.

Built from scratch in JAX (XLA/pjit) with the capabilities of
Molecolab-Pisa/diaglib (see SURVEY.md): block Davidson-Liu, LOBPCG
(standard + generalized), generalized Davidson, two Casida linear-response
solvers, and a two-sided nonsymmetric Davidson, on top of a family of
numerically hardened orthogonalization kernels.
"""

from . import config, ortho, utils
from .types import (
    LROps,
    LRSolverResult,
    NonsymResult,
    SolverOptions,
    SolverResult,
)

__version__ = "0.2.0"
