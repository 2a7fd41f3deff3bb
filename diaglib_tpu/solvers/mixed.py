"""Mixed-precision solve ladders (no reference analog).

The reference is double precision throughout (real_precision.f90: dp=8).
A matrix-free matvec is bound by the bytes of its operator, and an f32
store holds half the bytes of an f64 one, so f64 accuracy can be reached
through a precision ladder:

1. run the full solver in float32 until the residuals hit the f32 noise
   floor;
2. warm-start the float64 solver from the f32 Ritz vectors — the drivers
   already accept a guess (diaglib.f90:216-218 "in input, a guess"), and
   ``check_guess`` (or the LR drivers' guess split + B-orthonormalization)
   re-orthonormalizes it in the target precision — so only the last few
   iterations pay the f64 matvec price.

Whether the ladder beats a plain f64 solve on a given device is a
measurement (ROADMAP A5).

The final result is produced entirely by the f64 stage: eigenvalues,
residual norms and convergence flags carry full double-precision guarantees
(same dual rms/max tolerances as the reference, diaglib.f90:374-375).

All six reference drivers (diaglib.f90:166-167) get a ladder here:
``davidson_ladder``, ``lobpcg_ladder`` (std + generalized via ``bvec``),
``gen_david_ladder``, ``caslr_ladder``, ``caslr_eff_ladder``,
``nonsym_ladder``.  The LR ladders take the four-operator bundles as
:class:`LROps` per tier (apbmul/ambmul/spdmul/smdmul + lrprec — the
caslr_driver callback contract, diaglib.f90:569-570).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax.numpy as jnp

from ..types import (
    LROps,
    LRSolverResult,
    NonsymResult,
    SolverOptions,
    SolverResult,
)
from .caslr import caslr, caslr_eff
from .davidson import davidson, gen_david
from .lobpcg import lobpcg
from .nonsym import nonsym

__all__ = [
    "LROps",
    "davidson_ladder",
    "lobpcg_ladder",
    "gen_david_ladder",
    "caslr_ladder",
    "caslr_eff_ladder",
    "nonsym_ladder",
]


def _lo_options(options: SolverOptions, lo_tol, lo_iter) -> SolverOptions:
    return dataclasses.replace(
        options,
        tol=max(float(options.tol), float(lo_tol)),
        max_iter=lo_iter if lo_iter is not None else options.max_iter,
    )


def _two_stage(solver, matvec_lo, precnd_lo, matvec_hi, precnd_hi,
               evec_guess, options: SolverOptions, lo_tol, lo_iter, key,
               bvec_lo=None, bvec_hi=None):
    lo_opts = _lo_options(options, lo_tol, lo_iter)
    guess32 = jnp.asarray(evec_guess, jnp.float32)
    lo_kw = dict(bvec=bvec_lo) if bvec_lo is not None else {}
    hi_kw = dict(bvec=bvec_hi) if bvec_hi is not None else {}
    lo = solver(matvec_lo, precnd_lo, guess32, lo_opts, key=key, **lo_kw)
    hi_guess = lo.evec.astype(jnp.float64)
    hi = solver(matvec_hi, precnd_hi, hi_guess, options, key=key, **hi_kw)
    return SolverResult(
        eig=hi.eig,
        evec=hi.evec,
        ok=hi.ok,
        n_iter=lo.n_iter + hi.n_iter,
        n_matvec=lo.n_matvec + hi.n_matvec,
        done=hi.done,
        rms_history=hi.rms_history,
        max_history=hi.max_history,
        eig_history=hi.eig_history,
        # the f32 stage is a warm start only; a contaminated basis there
        # is re-orthonormalized by the f64 stage's check_guess, so only
        # the f64 stage's ortho health gates the result
        ortho_ok=hi.ortho_ok,
    )


def davidson_ladder(matvec_lo, precnd_lo, matvec_hi, precnd_hi, evec_guess,
                    options: SolverOptions, *, lo_tol: float = 2e-6,
                    lo_iter: int = None, key=None):
    """f32-then-f64 Davidson-Liu.

    ``matvec_lo``/``precnd_lo`` operate on float32 blocks (e.g. the BSR
    matvec over an f32 store of the operator), ``matvec_hi``/``precnd_hi``
    on float64.  ``lo_tol`` is the f32 stage's rms target — keep it above
    the f32 noise floor (~1e-6 · ||A||) or the stage burns its iteration
    budget without locking.  The f32 stage is not required to converge; its
    Ritz vectors are simply the warm start.

    Returns the f64 stage's :class:`SolverResult` with iteration/matvec
    counters accumulated over both stages.
    """
    return _two_stage(davidson, matvec_lo, precnd_lo, matvec_hi, precnd_hi,
                      evec_guess, options, lo_tol, lo_iter, key)


def lobpcg_ladder(matvec_lo, precnd_lo, matvec_hi, precnd_hi, evec_guess,
                  options: SolverOptions, *, lo_tol: float = 2e-6,
                  lo_iter: int = None, key=None, bvec_lo=None, bvec_hi=None):
    """f32-then-f64 LOBPCG; pass ``bvec_lo``/``bvec_hi`` for the
    generalized problem (lobpcg_driver gen_eig path, diaglib.f90:299-302)."""
    return _two_stage(lobpcg, matvec_lo, precnd_lo, matvec_hi, precnd_hi,
                      evec_guess, options, lo_tol, lo_iter, key,
                      bvec_lo=bvec_lo, bvec_hi=bvec_hi)


def gen_david_ladder(matvec_lo, precnd_lo, bvec_lo,
                     matvec_hi, precnd_hi, bvec_hi,
                     evec_guess, options: SolverOptions, *,
                     lo_tol: float = 2e-6, lo_iter: int = None, key=None):
    """f32-then-f64 generalized Davidson (gen_david_driver semantics,
    diaglib.f90:1855-2250).  The f64 stage B-orthonormalizes the warm-start
    block from scratch (b_ortho of the guess, diaglib.f90:2033-2034), so
    the f32 basis's metric errors do not leak into the f64 result."""
    lo_opts = _lo_options(options, lo_tol, lo_iter)
    guess32 = jnp.asarray(evec_guess, jnp.float32)
    lo = gen_david(matvec_lo, precnd_lo, bvec_lo, guess32, lo_opts, key=key)
    hi = gen_david(matvec_hi, precnd_hi, bvec_hi,
                   lo.evec.astype(jnp.float64), options, key=key)
    return dataclasses.replace(
        hi,
        n_iter=lo.n_iter + hi.n_iter,
        n_matvec=lo.n_matvec + hi.n_matvec,
    )


def caslr_ladder(ops_lo: LROps, ops_hi: LROps, evec_guess,
                 options: SolverOptions, *, algorithm: int = 1,
                 lo_tol: float = 2e-6, lo_iter: int = None, key=None):
    """f32-then-f64 Casida LR solver (caslr_driver, diaglib.f90:558-1022).

    The f64 stage re-orthonormalizes the split warm-start combos with
    ``ortho_cd`` in f64 (the driver's own guess handling), so the f32
    stage only has to land in the right subspace.
    """
    lo_opts = _lo_options(options, lo_tol, lo_iter)
    guess32 = jnp.asarray(evec_guess, jnp.float32)
    lo = caslr(ops_lo.apbmul, ops_lo.ambmul, ops_lo.spdmul, ops_lo.smdmul,
               ops_lo.lrprec, guess32, lo_opts, algorithm=algorithm, key=key)
    hi = caslr(ops_hi.apbmul, ops_hi.ambmul, ops_hi.spdmul, ops_hi.smdmul,
               ops_hi.lrprec, lo.evec.astype(jnp.float64), options,
               algorithm=algorithm, key=key)
    return dataclasses.replace(
        hi,
        n_iter=lo.n_iter + hi.n_iter,
        n_matvec=lo.n_matvec + hi.n_matvec,
    )


def caslr_eff_ladder(ops_lo: LROps, ops_hi: LROps, evec_guess,
                     options: SolverOptions, *, lo_tol: float = 2e-6,
                     lo_iter: int = None, key=None):
    """f32-then-f64 efficient Casida solver (caslr_eff_driver,
    diaglib.f90:1024-1481).  The f64 stage B-orthonormalizes the split
    warm-start combos against (A+B)/(A-B) from scratch
    (diaglib.f90:1246-1249), erasing the f32 metric noise."""
    lo_opts = _lo_options(options, lo_tol, lo_iter)
    guess32 = jnp.asarray(evec_guess, jnp.float32)
    lo = caslr_eff(ops_lo.apbmul, ops_lo.ambmul, ops_lo.spdmul,
                   ops_lo.smdmul, ops_lo.lrprec, guess32, lo_opts, key=key)
    hi = caslr_eff(ops_hi.apbmul, ops_hi.ambmul, ops_hi.spdmul,
                   ops_hi.smdmul, ops_hi.lrprec,
                   lo.evec.astype(jnp.float64), options, key=key)
    return dataclasses.replace(
        hi,
        n_iter=lo.n_iter + hi.n_iter,
        n_matvec=lo.n_matvec + hi.n_matvec,
    )


def nonsym_ladder(matvec_lo, matvec_l_lo, precnd_lo,
                  matvec_hi, matvec_l_hi, precnd_hi,
                  evec_guess, options: SolverOptions, *, side: str = "c",
                  lo_tol: float = 2e-6, lo_iter: int = None, key=None,
                  driver: str = "auto"):
    """f32-then-f64 two-sided nonsymmetric Davidson (nonsym_driver,
    diaglib.f90:2252-2943).  The f64 stage is seeded from the f32 stage's
    RIGHT eigenvectors (consecutive mode re-derives the left side from
    them anyway, diaglib.f90:2892-2901); ``check_guess`` + ``ortho_cd``
    re-orthonormalize in f64.  ``driver`` selects the reduced-eig path
    for both stages (see ``nonsym``)."""
    lo_opts = _lo_options(options, lo_tol, lo_iter)
    guess32 = jnp.asarray(evec_guess, jnp.float32)
    # the f32 stage exists only to produce the warm-start block, and for
    # consecutive/simultaneous sides the f64 stage re-derives its left
    # side from the right eigenvectors anyway — so the f32 LEFT pass
    # would be computed and thrown away: run the f32 stage one-sided.
    # (Compile cost matters too: one fewer full pass program.)
    lo_side = "r" if side in ("s", "c") else side
    lo = nonsym(matvec_lo, matvec_l_lo, precnd_lo, guess32, lo_opts,
                side=lo_side, key=key, driver=driver)
    lo_evec = lo.evec_l if side == "l" else lo.evec_r
    hi = nonsym(matvec_hi, matvec_l_hi, precnd_hi,
                lo_evec.astype(jnp.float64), options, side=side, key=key,
                driver=driver)
    return dataclasses.replace(
        hi,
        n_iter=lo.n_iter + hi.n_iter,
        n_matvec=lo.n_matvec + hi.n_matvec,
    )
