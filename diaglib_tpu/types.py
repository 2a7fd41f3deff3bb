"""Core types: operator callbacks, solver options, solver results.

Callback contract (replacement for the reference's ``external``
procedures, README.md:30-44 and diaglib.f90:62-72):

* ``matvec(x)``  — apply the operator to a *block of row vectors*
  ``x: (k, n) -> (k, n)``.  Row-major blocks keep the long axis ``n``
  contiguous and shard it across the device mesh; a Gram matrix is then a single
  ``x @ y.T`` contraction over ``n`` (an all-reduce under pjit).
* ``precnd(shift, r)`` — shift-aware preconditioner, ``(scalar, (k, n)) ->
  (k, n)`` (reference: ``precnd(n,m,shift,x,ax)``).
* ``bvec(x)`` — metric application for generalized problems.
* Casida operators ``apbmul/ambmul/spdmul/smdmul`` all map ``(k, n) -> (k, n)``
  and ``lrprec(fac, rp, rm) -> (yp, ym)`` (diaglib.f90:569-570).

All callbacks must be jittable and *linear* (they are applied to zero-padded
rows, which must stay zero).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

MatVec = Callable[[jax.Array], jax.Array]
PrecndFn = Callable[[jax.Array, jax.Array], jax.Array]
LRPrecndFn = Callable[[jax.Array, jax.Array, jax.Array], tuple]

__all__ = [
    "MatVec",
    "PrecndFn",
    "LRPrecndFn",
    "LROps",
    "SolverOptions",
    "SolverResult",
    "LRSolverResult",
    "NonsymResult",
]


@dataclasses.dataclass(frozen=True)
class LROps:
    """The Casida four-operator bundle + paired preconditioner
    (diaglib.f90:569-570 callback contract), e.g. one precision tier of a
    mixed-precision LR ladder (solvers/mixed.py)."""

    apbmul: MatVec
    ambmul: MatVec
    spdmul: MatVec
    smdmul: MatVec
    lrprec: LRPrecndFn


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Static solver configuration (hashable: usable as a jit static arg).

    Mirrors the reference driver arguments (diaglib.f90:171-228, 1483-1539):

    n_targ:   number of converged eigenpairs required.
    n_max:    block size / max subspace width per macro-block (>= n_targ).
    max_iter: maximum number of iterations.
    tol:      rms convergence threshold; the max-norm threshold is ``10*tol``
              (diaglib.f90:374-375).
    max_dav:  number of macro-blocks before a restart; effective value is
              ``max(10, max_dav)`` (diaglib.f90:1544, min_dav).
    shift:    diagonal level shift added to A (diaglib.f90:312).
    reduced_solver: where the small replicated reduced dense solves run:
              "device" (jnp.linalg), "host" (pure_callback to LAPACK, the
              reference's own split), "jacobi" (the on-device Jacobi
              kernels of utils/jacobi.py), or "auto" (= "device").  See
              utils/reduced.py.
    verbose:  emit one in-flight progress line per iteration via
              ``jax.debug.print`` (the reference's live per-root table,
              diaglib.f90:459-464; full per-root histories are always
              returned in the result and renderable post hoc with
              ``reporting.print_convergence_table``).  Requires a runtime
              with host debug callbacks (standard CPU/GPU runtimes; some
              experimental PJRT plugins lack them).
    """

    n_targ: int
    n_max: int
    max_iter: int = 100
    tol: float = 1e-8
    max_dav: int = 20
    shift: float = 0.0
    reduced_solver: str = "auto"
    verbose: bool = False

    def __post_init__(self):
        if self.n_max < self.n_targ:
            raise ValueError("n_max must be >= n_targ")

    @property
    def dim_dav(self) -> int:
        return max(10, self.max_dav)

    @property
    def tol_max(self) -> float:
        return 10.0 * self.tol


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SolverResult:
    """Result of a symmetric eigensolver.

    eig:  (n_max,) eigenvalues ascending (shift removed).
    evec: (n_max, n) eigenvector rows.
    ok:   scalar bool, True if the first n_targ roots converged.
    n_iter: iterations performed.
    n_matvec: operator applications counted like the reference's ``nmult``
              (utils.f90:6) -- one count per vector in each applied block.
    done: (n_max,) per-root converged flags (contiguous prefix,
          diaglib.f90:446-455).
    rms_history/max_history/eig_history: (max_iter, n_max) per-iteration
          convergence tables (the reference prints these when verbose,
          diaglib.f90:381-385; we return them).
    ortho_ok: scalar bool, False if any orthogonalization step failed to
          converge during the solve (the reference hard-stops there,
          diaglib.f90:3568/3657; here the contaminated-basis condition is
          reported so callers can reject or retry the solve).
    """

    eig: jax.Array
    evec: jax.Array
    ok: jax.Array
    n_iter: jax.Array
    n_matvec: jax.Array
    done: jax.Array
    rms_history: jax.Array
    max_history: jax.Array
    eig_history: jax.Array
    ortho_ok: jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LRSolverResult:
    """Result of a Casida linear-response solver (caslr/caslr_eff drivers).

    evec rows are the paired vectors (Y, Z) of length 2n.
    ``ortho_ok`` as in SolverResult.
    """

    eig: jax.Array
    evec: jax.Array
    ok: jax.Array
    n_iter: jax.Array
    n_matvec: jax.Array
    done: jax.Array
    rms_history: jax.Array
    max_history: jax.Array
    eig_history: jax.Array
    ortho_ok: jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class NonsymResult:
    """Result of the two-sided nonsymmetric Davidson (nonsym_driver).

    ``ortho_ok`` as in SolverResult.
    """

    eig: jax.Array
    evec_r: jax.Array
    evec_l: jax.Array
    ok: jax.Array
    n_iter: jax.Array
    n_matvec: jax.Array
    done: jax.Array
    rms_history_r: jax.Array
    max_history_r: jax.Array
    rms_history_l: jax.Array
    max_history_l: jax.Array
    eig_history: jax.Array
    ortho_ok: jax.Array
