"""Block Davidson-Liu eigensolvers: standard and generalized.

Re-designs the reference's ``davidson_driver`` (diaglib.f90:1483-1853) and
``gen_david_driver`` (diaglib.f90:1855-2250) as a single jit-compiled
``lax.while_loop``.  The Fortran grows its expansion space by appending
columns with dynamic index arithmetic; XLA needs static shapes, so here the
space lives in a fixed padded buffer ``space: (lda_pad, n)`` (rows are
vectors) with a scalar row count ``ldu`` and boolean masks — exactly the
capacity bound the Fortran itself allocates (``lda = dim_dav*n_max``,
diaglib.f90:1596) plus one block of scatter padding.

Semantics preserved from the reference:

* incremental reduced-matrix update — only the new block's rows of ``a_red``
  are computed each iteration (diaglib.f90:1691, 2078);
* contiguous-prefix locking with no locking at iteration 1
  (diaglib.f90:1737-1746); converged roots are frozen (their residuals and
  preconditioned updates are skipped) but stay in the space;
* the preconditioner is called with the single shift ``-eig(ind)`` of the
  first active root (diaglib.f90:1785-1786, 2176-2177);
* restart when the space is full: collapse onto the current Ritz vectors,
  skip the matvecs of locked roots at the next iteration by seeding the
  reduced matrix's diagonal with their eigenvalues (diaglib.f90:1795-1825,
  1696-1702);
* dual tolerance: rms = ||r||/sqrt(n) < tol and max|r| < 10*tol
  (diaglib.f90:1622-1624, 1739-1741).

Generalized path (A x = λ B x, ``gen_david``): the expansion space is kept
**B-orthonormal** so the reduced problem stays a standard symmetric one
(diaglib.f90:2033-2034, 2098, 2183-2185); the residual uses B·evec
(diaglib.f90:2111-2123).  The reference's restart zeroes ``bspace`` right
after re-B-orthonormalizing with it (diaglib.f90:2199-2200), silently
corrupting every post-restart iteration; this rebuild keeps ``bspace``
consistent (SURVEY.md §2.1 S3: reproduce the converged behavior, not the
bug).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ortho.core import b_ortho, b_ortho_vs_x, ortho_vs_x
from ..types import SolverOptions, SolverResult
from ..utils.guess import check_guess
from ..utils.mm import mm, mTm, mmT
from ..utils.masking import (
    gather_rows,
    masked_eigh_bucketed,
    prefix_lock,
    prefix_mask,
    scatter_rows,
)

__all__ = ["davidson", "gen_david"]


class _DavidsonState(NamedTuple):
    it: jax.Array          # iteration counter (0-based)
    space: jax.Array       # (lda_pad, n) expansion vectors, rows valid < ldu
    aspace: jax.Array      # (lda_pad, n) A @ space rows
    bspace: jax.Array      # (lda_pad, n) B @ space rows (generalized only)
    a_red: jax.Array       # (lda_pad, lda_pad) reduced matrix, lower-filled
    ldu: jax.Array         # valid rows of space
    n_act: jax.Array       # active (unconverged) block width
    n_rst: jax.Array       # matvecs to skip right after a restart
    m_dim: jax.Array       # macro-iterations since last restart
    eig: jax.Array         # (n_max,) current Ritz values
    evec: jax.Array        # (n_max, n) current Ritz vectors
    done: jax.Array        # (n_max,) locked roots (contiguous prefix)
    rms: jax.Array         # (n_max,) last computed rms norms
    rmx: jax.Array         # (n_max,) last computed max norms
    ok: jax.Array          # all n_targ roots converged
    ortho_ok: jax.Array    # no orthogonalization step failed so far
    n_matvec: jax.Array    # operator applications (reference nmult semantics)
    eig_h: jax.Array       # (max_iter, n_max) histories
    rms_h: jax.Array
    max_h: jax.Array


def _davidson_impl(matvec, precnd, bvec, evec_guess, options: SolverOptions,
                   key, sharding=None):
    from ..parallel.sharding import constrainers

    vec, rep = constrainers(sharding)
    gen_eig = bvec is not None
    n_targ, n_max = options.n_targ, options.n_max
    lda = options.dim_dav * n_max
    lda_pad = lda + n_max
    max_iter = options.max_iter
    evec_guess = jnp.asarray(evec_guess)
    k_rows, n = evec_guess.shape
    if k_rows != n_max:
        raise ValueError(f"guess must have n_max={n_max} rows, got {k_rows}")
    dtype = evec_guess.dtype
    sqrtn = jnp.sqrt(jnp.asarray(n, dtype))
    tol_rms = jnp.asarray(options.tol, dtype)
    tol_max = jnp.asarray(options.tol_max, dtype)
    if key is None:
        key = jax.random.PRNGKey(0)

    guess = check_guess(evec_guess, key)
    if gen_eig:
        bguess = bvec(guess)
        guess, bguess, b_ok0 = b_ortho(guess, bguess)
    else:
        bguess = jnp.zeros_like(guess)
        b_ok0 = jnp.asarray(True)

    def cond(s: _DavidsonState):
        return (~s.ok) & (s.it < max_iter)

    def body(s: _DavidsonState):
        ldu_new = s.ldu + s.n_act
        # the matvec block starts past the n_rst roots whose products are
        # skipped right after a restart (Fortran i_beg + n_rst,
        # diaglib.f90:1685); n_rst is 0 on the normal path
        start = s.ldu + s.n_rst
        width_valid = ldu_new - start

        with jax.named_scope("matvec"):
            block = gather_rows(s.space, start, n_max, count=width_valid)
            ablock = matvec(block)
            ablock = jnp.where((jnp.arange(n_max) < width_valid)[:, None],
                               ablock, 0.0)
            aspace = scatter_rows(s.aspace, ablock, start)
        n_matvec = s.n_matvec + s.n_act

        # incremental reduced-matrix rows: a_red[g, j] = aspace_g . space_j
        # (row-filled lower triangle; the Fortran fills columns of the upper
        # one, diaglib.f90:1691 — same data, transposed layout)
        new_rows = mmT(ablock, s.space)  # (n_max, lda_pad)
        col_ok = prefix_mask(lda_pad, ldu_new)
        new_rows = jnp.where(col_ok[None, :], new_rows, 0.0)
        a_red = scatter_rows(s.a_red, new_rows, start)

        with jax.named_scope("rayleigh-ritz"):
            sym = jnp.tril(a_red) + jnp.tril(a_red, -1).T
            # adaptive reduced-solve tolerance for the Jacobi route: the
            # intermediate solves only need to stay ~2 orders below the
            # current residual level (Davidson is self-correcting), so
            # relax the off-norm target proportionally to the smallest
            # active rms, and let it tighten to machine eps as
            # convergence approaches (the final solves are full accuracy)
            prev_rms = jnp.min(jnp.where((~s.done)
                                         & (jnp.arange(n_max) < n_targ),
                                         s.rms, jnp.inf))
            scale = jnp.maximum(jnp.max(jnp.abs(s.eig)), 1.0)
            off_tol = jnp.clip(0.01 * prev_rms / scale, 0.0, 1e-5)
            # solve only the smallest prefix bucket covering ldu_new: the
            # reduced matrix grows one block per iteration, so early
            # iterations pay L^3 at L ~ n_max instead of lda_pad
            # fine (linear) buckets past 2*n_max: the reduced solve is the
            # f64 stage's largest term and the doubling jump at the top of
            # the space nearly doubles it (masking.prefix_buckets)
            e_red, c_full = masked_eigh_bucketed(
                sym, col_ok, ldu_new, lo=2 * n_max,
                method=options.reduced_solver, off_tol=off_tol, fine=True)
            eig = e_red[:n_max]
            c = c_full[:, :n_max]  # (lda_pad, n_max) reduced eigenvectors

            evec = mTm(c, s.space)
            metric_evec = mTm(c, s.bspace) if gen_eig else evec
            r = mTm(c, aspace) - eig[:, None] * metric_evec

        active = (~s.done) & (jnp.arange(n_max) < n_targ)
        rms_new = jnp.linalg.norm(r, axis=1) / sqrtn
        max_new = jnp.max(jnp.abs(r), axis=1)
        rms = jnp.where(active, rms_new, s.rms)
        rmx = jnp.where(active, max_new, s.rmx)

        conv = (rms < tol_rms) & (rmx < tol_max) & (s.it > 0)
        done = prefix_lock(s.done, conv, n_targ)
        ok = jnp.all(jnp.where(jnp.arange(n_max) < n_targ, done, True))

        eig_h = s.eig_h.at[s.it].set(eig - options.shift)
        rms_h = s.rms_h.at[s.it].set(rms)
        max_h = s.max_h.at[s.it].set(rmx)
        if options.verbose:
            from ..reporting import inflight_progress
            inflight_progress("davidson", s.it, s.n_act, eig_h[s.it],
                              rms, rmx)


        n_frozen = jnp.sum(done, dtype=jnp.int32)
        n_act_new = (n_max - n_frozen).astype(jnp.int32)

        @jax.named_scope("expand-ortho")
        def expand(_):
            shift = -eig[n_frozen]
            rblk = gather_rows(r, n_frozen, n_max, count=n_act_new)
            pre = precnd(shift, rblk)
            umask = jnp.arange(n_max) < n_act_new
            pre = jnp.where(umask[:, None], pre, 0.0)
            if gen_eig:
                unew, o_done = b_ortho_vs_x(
                    s.space, s.bspace, pre, xmask=col_ok, umask=umask)
                bnew = bvec(unew)
                bnew = jnp.where(umask[:, None], bnew, 0.0)
                unew, bnew, b_ok = b_ortho(unew, bnew, umask)
                o_done = o_done & b_ok
                bspace2 = scatter_rows(s.bspace, bnew, ldu_new)
            else:
                unew, o_done = ortho_vs_x(
                    s.space, pre, xmask=col_ok, umask=umask)
                bspace2 = s.bspace
            return (
                scatter_rows(s.space, unew, ldu_new),
                aspace,
                bspace2,
                a_red,
                ldu_new,
                n_act_new,
                jnp.asarray(0, jnp.int32),
                s.m_dim + 1,
                s.ortho_ok & o_done,
            )

        def restart(_):
            if gen_eig:
                # collapse + re-B-orthonormalize the Ritz block
                # (diaglib.f90:2196-2198; bspace KEPT, see module docstring)
                ev, bev, b_ok = b_ortho(evec, metric_evec)
            else:
                ev, bev, b_ok = evec, metric_evec, jnp.asarray(True)
            sp = scatter_rows(jnp.zeros_like(s.space), ev, 0)
            bsp = (scatter_rows(jnp.zeros_like(s.bspace), bev, 0)
                   if gen_eig else s.bspace)
            ar = jnp.zeros_like(s.a_red)
            # seed locked eigenvalues so their matvecs can be skipped
            # (diaglib.f90:1696-1702, 1817-1823)
            seed = jnp.where(jnp.arange(lda_pad) < n_frozen,
                             jnp.pad(eig, (0, lda_pad - n_max)), 0.0)
            ar = ar + jnp.diag(seed)
            return (
                sp,
                jnp.zeros_like(aspace),
                bsp,
                ar,
                jnp.asarray(0, jnp.int32),
                jnp.asarray(n_max, jnp.int32),
                n_frozen.astype(jnp.int32),
                jnp.asarray(1, jnp.int32),
                s.ortho_ok & b_ok,
            )

        def noop(_):
            return (s.space, aspace, s.bspace, a_red, ldu_new, s.n_act,
                    jnp.asarray(0, jnp.int32), s.m_dim, s.ortho_ok)

        (space2, aspace2, bspace2, a_red2, ldu2, n_act2, n_rst2,
         m_dim2, ortho_ok2) = jax.lax.cond(
            ok,
            noop,
            lambda _: jax.lax.cond(s.m_dim < options.dim_dav, expand,
                                   restart, None),
            None,
        )

        return _DavidsonState(
            it=s.it + 1, space=space2, aspace=aspace2, bspace=bspace2,
            a_red=a_red2, ldu=ldu2, n_act=n_act2, n_rst=n_rst2, m_dim=m_dim2,
            eig=eig, evec=evec, done=done, rms=rms, rmx=rmx, ok=ok,
            ortho_ok=ortho_ok2,
            n_matvec=n_matvec, eig_h=eig_h, rms_h=rms_h, max_h=max_h,
        )

    space0 = vec(scatter_rows(jnp.zeros((lda_pad, n), dtype), guess, 0))
    bspace0 = vec(scatter_rows(jnp.zeros((lda_pad, n), dtype), bguess, 0))
    init = _DavidsonState(
        it=jnp.asarray(0, jnp.int32),
        space=space0,
        aspace=vec(jnp.zeros((lda_pad, n), dtype)),
        bspace=bspace0,
        a_red=rep(jnp.zeros((lda_pad, lda_pad), dtype)),
        ldu=jnp.asarray(0, jnp.int32),
        n_act=jnp.asarray(n_max, jnp.int32),
        n_rst=jnp.asarray(0, jnp.int32),
        m_dim=jnp.asarray(1, jnp.int32),
        eig=jnp.zeros((n_max,), dtype),
        evec=vec(jnp.zeros((n_max, n), dtype)),
        done=jnp.zeros((n_max,), bool),
        rms=jnp.full((n_max,), jnp.inf, dtype),
        rmx=jnp.full((n_max,), jnp.inf, dtype),
        ok=jnp.asarray(False),
        ortho_ok=b_ok0,
        n_matvec=jnp.asarray(0, jnp.int32),
        eig_h=jnp.zeros((max_iter, n_max), dtype),
        rms_h=jnp.full((max_iter, n_max), jnp.inf, dtype),
        max_h=jnp.full((max_iter, n_max), jnp.inf, dtype),
    )

    out = jax.lax.while_loop(cond, body, init)
    return SolverResult(
        eig=out.eig - options.shift,
        evec=out.evec,
        ok=out.ok,
        n_iter=out.it,
        n_matvec=out.n_matvec,
        done=out.done,
        rms_history=out.rms_h,
        max_history=out.max_h,
        eig_history=out.eig_h,
        ortho_ok=out.ortho_ok,
    )


def davidson(matvec, precnd, evec_guess, options: SolverOptions, *, key=None,
             sharding=None):
    """Compute the lowest eigenpairs of a symmetric operator.

    Args:
      matvec: jittable linear callback ``(k, n) -> (k, n)`` (rows are
        vectors); must map zero rows to zero rows.
      precnd: jittable ``(shift_scalar, (k, n)) -> (k, n)`` preconditioner.
      evec_guess: (n_max, n) initial guess rows; pass zeros for a random
        start (check_guess semantics, diaglib.f90:3734-3786).
      options: SolverOptions (n_targ, n_max, max_iter, tol, max_dav, shift).
      key: PRNG key for the random guess fallback.

    Returns a SolverResult; ``eig``/``evec`` hold the n_max Ritz pairs
    (shift removed from eig like the reference's printout, diaglib.f90:1752).
    ``sharding``: optional parallel.VectorSharding distributing the n axis
    over a device mesh.
    """
    return _davidson_impl(matvec, precnd, None, evec_guess, options, key,
                          sharding)


def gen_david(matvec, precnd, bvec, evec_guess, options: SolverOptions, *,
              key=None, sharding=None):
    """Generalized Davidson for A x = λ B x with B-orthonormal expansion
    space (gen_david_driver, diaglib.f90:1855-2250).

    ``bvec`` applies the SPD metric B to a row block.  The reduced problem
    stays a standard symmetric eigenproblem because the space is kept
    B-orthonormal (diaglib.f90:2098).
    """
    return _davidson_impl(matvec, precnd, bvec, evec_guess, options, key,
                          sharding)
