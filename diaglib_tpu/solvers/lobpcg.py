"""LOBPCG eigensolver, standard and generalized.

Re-designs the reference's ``lobpcg_driver`` (diaglib.f90:171-556) as a
jit-compiled ``lax.while_loop`` over a fixed three-block subspace.  The
Fortran packs the blocks contiguously as ``[X(n_max), P(n_act), W(n_act)]``
with moving offsets; XLA wants static layout, so here each block owns a fixed
``n_max``-row slot of ``space: (3*n_max, n)`` and validity masks carry the
active counts — mathematically identical, statically shaped.

Preserved semantics:

* initial Rayleigh-Ritz of the (B-orthonormalized) guess, then an explicit
  first half-iteration building W from preconditioned residuals
  (diaglib.f90:304-367);
* per-iteration: matvec on W only; full reduced Gram over the valid blocks;
  dsyev; rotation of x/ax/bx (diaglib.f90:389-424);
* P update via coefficient differences orthogonalized against the new X
  coefficients, so no extra matvecs are spent on P (``get_coeffs``,
  diaglib.f90:3686-3732);
* diagonal level shift added to A by the driver itself (diaglib.f90:312,
  397), removed from the reported eigenvalues (461);
* preconditioner called with the single shift ``shift - eig(1)``
  (diaglib.f90:352, 518);
* generalized path: B-orthonormal X/P/W chain via b_ortho_vs_x + bvec +
  b_ortho (diaglib.f90:299-302, 357-364, 523-526);
* locking scans all n_max roots (diaglib.f90:446-455), convergence requires
  the first n_targ.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..ortho.core import b_ortho, b_ortho_vs_x, ortho_vs_x
from ..types import SolverOptions, SolverResult
from ..utils.guess import check_guess
from ..utils.mm import mm, mTm, mmT
from ..utils.masking import gather_rows, masked_eigh, prefix_lock, scatter_rows
from ..utils import reduced

__all__ = ["lobpcg"]


class _LobpcgState(NamedTuple):
    it: jax.Array
    space: jax.Array    # (3*n_max, n): [X | P | W] fixed slots
    aspace: jax.Array
    bspace: jax.Array   # only meaningful when gen_eig
    n_act: jax.Array    # valid rows in the W slot
    p_count: jax.Array  # valid rows in the P slot
    eig: jax.Array
    evec: jax.Array
    done: jax.Array
    rms: jax.Array
    rmx: jax.Array
    ok: jax.Array
    ortho_ok: jax.Array
    n_matvec: jax.Array
    eig_h: jax.Array
    rms_h: jax.Array
    max_h: jax.Array


def lobpcg(matvec, precnd, evec_guess, options: SolverOptions, *,
           bvec=None, key=None, sharding=None):
    """Locally-optimal block preconditioned CG for A x = λ x (or λ B x).

    Args:
      matvec: jittable ``(k, n) -> (k, n)`` applying A to row vectors.
      precnd: jittable ``(shift_scalar, (k, n)) -> (k, n)``.
      evec_guess: (n_max, n) guess rows (zeros => random via check_guess).
      options: SolverOptions; ``options.shift`` is added to A by the driver
        (diaglib.f90:312) and removed from the reported eigenvalues.
      bvec: metric apply for the generalized problem (``gen_eig`` in the
        reference is ``bvec is not None`` here).
      key: PRNG key for the random-guess fallback.
      sharding: optional parallel.VectorSharding distributing n over a mesh.
    """
    from ..parallel.sharding import constrainers

    vec, rep = constrainers(sharding)
    gen_eig = bvec is not None
    n_targ, n_max = options.n_targ, options.n_max
    max_iter = options.max_iter
    evec_guess = jnp.asarray(evec_guess)
    if evec_guess.shape[0] != n_max:
        raise ValueError(f"guess must have n_max={n_max} rows")
    n = evec_guess.shape[1]
    dtype = evec_guess.dtype
    len_a = 3 * n_max
    sqrtn = jnp.sqrt(jnp.asarray(n, dtype))
    tol_rms = jnp.asarray(options.tol, dtype)
    tol_max = jnp.asarray(options.tol_max, dtype)
    shift = jnp.asarray(options.shift, dtype)
    if key is None:
        key = jax.random.PRNGKey(0)

    idx_b = jnp.arange(n_max)

    def apply_a(x):
        return matvec(x) + shift * x

    def build_w(space, bspace, r, n_frozen, n_act, eig0, p_valid):
        """Preconditioned residuals, orthogonalized against [X | P]."""
        umask = idx_b < n_act
        rblk = gather_rows(r, n_frozen, n_max, count=n_act)
        w = precnd(shift - eig0, rblk)
        w = jnp.where(umask[:, None], w, 0.0)
        xp = space[: 2 * n_max]
        xmask = jnp.concatenate([jnp.ones((n_max,), bool), p_valid])
        if gen_eig:
            bxp = bspace[: 2 * n_max]
            w, o_done = b_ortho_vs_x(xp, bxp, w, xmask=xmask, umask=umask)
            bw = bvec(w)
            bw = jnp.where(umask[:, None], bw, 0.0)
            w, bw, b_ok = b_ortho(w, bw, umask)
            o_done = o_done & b_ok
        else:
            w, o_done = ortho_vs_x(xp, w, xmask=xmask, umask=umask)
            bw = jnp.zeros_like(w)
        return w, bw, o_done

    # ---- prologue: Rayleigh-Ritz of the guess + explicit first W block ----
    guess = check_guess(evec_guess, key)
    if gen_eig:
        bx = bvec(guess)
        x, bx, b_ok0 = b_ortho(guess, bx)
    else:
        x = guess
        bx = jnp.zeros_like(guess)
        b_ok0 = jnp.asarray(True)
    ax = apply_a(x)
    g0 = mmT(x, ax)
    e0, c0 = reduced.eigh(0.5 * (g0 + g0.T), options.reduced_solver)
    eig0 = e0
    x = mTm(c0, x)
    ax = mTm(c0, ax)
    if gen_eig:
        bx = mTm(c0, bx)
    r0 = ax - eig0[:, None] * (bx if gen_eig else x)

    pv0 = jnp.zeros((n_max,), bool)
    w0, bw0, o_done0 = build_w(
        jnp.concatenate([x, jnp.zeros((2 * n_max, n), dtype)]),
        jnp.concatenate([bx, jnp.zeros((2 * n_max, n), dtype)]),
        r0, jnp.asarray(0, jnp.int32), jnp.asarray(n_max, jnp.int32),
        eig0[0], pv0,
    )

    space0 = vec(jnp.concatenate([x, jnp.zeros((n_max, n), dtype), w0]))
    aspace0 = vec(jnp.concatenate([ax, jnp.zeros((2 * n_max, n), dtype)]))
    bspace0 = vec(jnp.concatenate([bx, jnp.zeros((n_max, n), dtype), bw0]))

    def cond(s: _LobpcgState):
        return (~s.ok) & (s.it < max_iter)

    def body(s: _LobpcgState):
        w_mask = idx_b < s.n_act
        p_valid = idx_b < s.p_count
        w = s.space[2 * n_max:]
        aw = apply_a(w)
        aw = jnp.where(w_mask[:, None], aw, 0.0)
        aspace = scatter_rows(s.aspace, aw, 2 * n_max)
        n_matvec = s.n_matvec + s.n_act

        mask = jnp.concatenate([jnp.ones((n_max,), bool), p_valid, w_mask])
        g = mmT(s.space, aspace)
        # adaptive Jacobi off-norm target: intermediate reduced solves only
        # need ~2 orders below the current residual (see davidson.py note)
        prev_rms = jnp.min(jnp.where(~s.done, s.rms, jnp.inf))
        scale_t = jnp.maximum(jnp.max(jnp.abs(s.eig)), 1.0)
        off_tol = jnp.clip(0.01 * prev_rms / scale_t, 0.0, 1e-5)
        e_red, c_full = masked_eigh(0.5 * (g + g.T), mask,
                                    method=options.reduced_solver,
                                    off_tol=off_tol)
        eig = e_red[:n_max]
        c = c_full[:, :n_max]  # (3*n_max, n_max)

        x_new = mTm(c, s.space)
        ax_new = mTm(c, aspace)
        bx_new = mTm(c, s.bspace) if gen_eig else jnp.zeros_like(x_new)

        metric_x = bx_new if gen_eig else x_new
        r = ax_new - eig[:, None] * metric_x
        active = ~s.done
        rms = jnp.where(active, jnp.linalg.norm(r, axis=1) / sqrtn, s.rms)
        rmx = jnp.where(active, jnp.max(jnp.abs(r), axis=1), s.rmx)

        conv = (rms < tol_rms) & (rmx < tol_max) & (s.it > 0)
        done = prefix_lock(s.done, conv, n_max)
        ok = jnp.all(jnp.where(idx_b < n_targ, done, True))

        eig_h = s.eig_h.at[s.it].set(eig - shift)
        rms_h = s.rms_h.at[s.it].set(rms)
        max_h = s.max_h.at[s.it].set(rmx)
        if options.verbose:
            from ..reporting import inflight_progress
            inflight_progress("lobpcg", s.it, s.n_act, eig_h[s.it],
                              rms, rmx)


        n_frozen = jnp.sum(done, dtype=jnp.int32)
        n_act_new = (n_max - n_frozen).astype(jnp.int32)

        def update(_):
            # P from coefficient differences (get_coeffs, diaglib.f90:3686)
            u_x = c.T  # (n_max, 3*n_max) rows of reduced eigenvector coeffs
            u_p = gather_rows(u_x, n_frozen, n_max, count=n_act_new)
            # subtract the old-x component: u_p[i] -= e_{n_frozen + i}
            onehots = jax.nn.one_hot(n_frozen + idx_b, len_a, dtype=dtype)
            umask = idx_b < n_act_new
            u_p = u_p - jnp.where(umask[:, None], onehots, 0.0)
            u_p, p_done = ortho_vs_x(u_x, u_p, umask=umask)

            p_new = mm(u_p, s.space)
            ap_new = mm(u_p, aspace)
            bp_new = mm(u_p, s.bspace) if gen_eig else jnp.zeros_like(p_new)

            sp = jnp.concatenate([x_new, p_new, jnp.zeros((n_max, n), dtype)])
            asp = jnp.concatenate([ax_new, ap_new, jnp.zeros((n_max, n), dtype)])
            bsp = jnp.concatenate([bx_new, bp_new, jnp.zeros((n_max, n), dtype)])

            w_new, bw_new, w_done = build_w(sp, bsp, r, n_frozen, n_act_new,
                                            eig[0], umask)
            sp = scatter_rows(sp, w_new, 2 * n_max)
            bsp = scatter_rows(bsp, bw_new, 2 * n_max)
            return (sp, asp, bsp, n_act_new, n_act_new,
                    s.ortho_ok & p_done & w_done)

        def finish(_):
            return s.space, aspace, s.bspace, s.n_act, s.p_count, s.ortho_ok

        space2, aspace2, bspace2, n_act2, p_count2, ortho_ok2 = jax.lax.cond(
            ok, finish, update, None
        )

        return _LobpcgState(
            it=s.it + 1, space=space2, aspace=aspace2, bspace=bspace2,
            n_act=n_act2, p_count=p_count2, eig=eig, evec=x_new, done=done,
            rms=rms, rmx=rmx, ok=ok, ortho_ok=ortho_ok2, n_matvec=n_matvec,
            eig_h=eig_h, rms_h=rms_h, max_h=max_h,
        )

    init = _LobpcgState(
        it=jnp.asarray(0, jnp.int32),
        space=space0, aspace=aspace0, bspace=bspace0,
        n_act=jnp.asarray(n_max, jnp.int32),
        p_count=jnp.asarray(0, jnp.int32),
        eig=eig0, evec=vec(x), done=jnp.zeros((n_max,), bool),
        rms=jnp.full((n_max,), jnp.inf, dtype),
        rmx=jnp.full((n_max,), jnp.inf, dtype),
        ok=jnp.asarray(False),
        ortho_ok=o_done0 & b_ok0,
        n_matvec=jnp.asarray(n_max, jnp.int32),
        eig_h=jnp.zeros((max_iter, n_max), dtype),
        rms_h=jnp.full((max_iter, n_max), jnp.inf, dtype),
        max_h=jnp.full((max_iter, n_max), jnp.inf, dtype),
    )

    out = jax.lax.while_loop(cond, body, init)
    return SolverResult(
        eig=out.eig - shift,
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
