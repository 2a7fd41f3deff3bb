"""Casida linear-response eigensolvers.

Solves the paired response problem

    [[A, B], [B, A]] (Y, Z) = w [[S, D], [-D, -S]] (Y, Z)

in the symmetric/antisymmetric combinations vp = Y+Z, vm = Y-Z, through four
operator callbacks apbmul = (A+B)·, ambmul = (A-B)·, spdmul = (S+D)·,
smdmul = (S-D)· and a paired preconditioner ``lrprec``.

Two drivers, both jit-compiled ``lax.while_loop``s over fixed padded
subspaces (rows are vectors):

* ``caslr``     — the reference's ``caslr_driver`` (diaglib.f90:558-1022):
  plain-orthonormal vp/vm spaces; per iteration 4 operator applications on
  the new block; reduced 2·ldu generalized problem.  Two reduced-solve
  algorithms: ``algorithm=0`` solves the inverse pencil
  ``S_red x = e A_red x`` and takes eigenvalues as 1/e from the top
  (diaglib.f90:773-803); ``algorithm=1`` is the Helmich-Paris scheme: SVD of
  smat, scaled projections, two Cholesky factors, C = (L-)^T L+, second SVD
  (diaglib.f90:805-872; per JCTC 2021, Helmich-Paris).
* ``caslr_eff`` — the reference's ``caslr_eff_driver``
  (diaglib.f90:1024-1481, per Stratmann-Scuseria-Frisch JCP 109, 8218):
  expansion vectors kept B-orthonormal w.r.t. (A+B) and (A-B), so the
  reduced problem collapses to the half-size symmetric ``s^T s`` eigenvalue
  problem; only 2 operator applications per iteration in the loop;
  eigenvalues carried as 1/w internally, inverted on exit
  (diaglib.f90:1310, 1376-1379).

Static-shape mapping: fixed buffers (lda_pad, n) with a scalar valid-row
count ``ldu`` and prefix masks, exactly as in the Davidson driver.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from ..ortho.core import b_ortho, b_ortho_vs_x, ortho_cd, ortho_vs_x
from ..utils import reduced
from ..utils.mm import mm, mTm, mmT
from ..types import LRSolverResult, SolverOptions
from ..utils.masking import (
    gather_rows,
    masked_svd,
    prefix_lock,
    prefix_mask,
    scatter_rows,
)

__all__ = ["caslr", "caslr_eff"]


def _split_guess(evec_guess, n_max):
    """(n_max, 2n) paired rows -> (vp, vm) = (Y+Z, Y-Z) (diaglib.f90:711-714)."""
    evec_guess = jnp.asarray(evec_guess)
    if evec_guess.shape[0] != n_max:
        raise ValueError(f"guess must have n_max={n_max} rows")
    n2 = evec_guess.shape[1]
    if n2 % 2:
        raise ValueError("guess rows must have even length 2n")
    n = n2 // 2
    y, z = evec_guess[:, :n], evec_guess[:, n:]
    return y + z, y - z, n


def _nonzero_or_random(v, key):
    """Per-row random fallback for zero guess rows.

    The reference would feed zeros straight into ortho_cd and die; the
    repair here is row-granular (check_guess contract,
    diaglib.f90:3734-3786): a guess with *some* zero rows gets only those
    rows replaced, so the caller's nonzero rows are kept verbatim and a
    fully zero block becomes fully random."""
    row_norm = jnp.linalg.norm(v, axis=1)
    rnd = jax.random.uniform(key, v.shape, dtype=v.dtype) - 0.5
    return jnp.where((row_norm == 0.0)[:, None], rnd, v)


def _combine(eigp, eigm):
    """(Y, Z) rows of length 2n from the plus/minus components
    (diaglib.f90:878-881)."""
    return jnp.concatenate([eigp + eigm, eigp - eigm], axis=1)


def _pad_eye(a, mask):
    outer = mask[:, None] & mask[None, :]
    return jnp.where(outer, a, 0.0) + jnp.diag(jnp.where(mask, 0.0, 1.0))


def _pad_zero(a, mask):
    outer = mask[:, None] & mask[None, :]
    return jnp.where(outer, a, 0.0)


def _reduced_inverse_pencil(epmat, emmat, smat, mask, n_max, method,
                            off_tol=0.0):
    """algorithm=0 reduced solve (diaglib.f90:773-803), half-size form.

    The reference diagonalizes the full 2L pencil S_red x = e A_red x,
    A_red = diag(ep, em) (SPD), S_red = [[0, s^T], [s, 0]], with dsygv.
    The block structure eliminates EXACTLY to the L-size SPD pencil

        (s ep^{-1} s^T) um = e^2 em um,    up = ep^{-1} s^T um / e,

    whose positive branch e = +sqrt(e^2) is the n_max-largest-e set the
    full solve would return, with the same dsygv itype=1 normalization
    (x^T A_red x = 1: both half-blocks carry weight 1/2, hence the
    1/sqrt(2)).  ~8x less reduced-solve work.
    """
    from jax.scipy.linalg import solve_triangular

    ep = _pad_eye(0.5 * (epmat + epmat.T), mask)
    em = _pad_eye(0.5 * (emmat + emmat.T), mask)
    sz = _pad_zero(smat, mask)
    lp = reduced.cholesky(ep, method)
    w = solve_triangular(lp, sz.T, lower=True)      # lp^{-1} s^T
    g = mTm(w, w)                                   # s ep^{-1} s^T
    e2, um = reduced.eigh_gen(0.5 * (g + g.T), em, method, off_tol=off_tol)
    # pads sit at e^2 = 0; the n_max largest genuine values are trailing
    e2_top = e2[::-1][:n_max]
    um_top = um[:, ::-1][:, :n_max]
    e_top = jnp.sqrt(jnp.maximum(e2_top, 0.0))
    eig = 1.0 / e_top                               # w = 1/e
    up_top = solve_triangular(lp, mm(w, um_top), lower=True, trans=1)
    up_top = up_top * eig[None, :]                  # /e
    inv_sqrt2 = 1.0 / jnp.sqrt(jnp.asarray(2.0, smat.dtype))
    return eig, up_top * inv_sqrt2, um_top * inv_sqrt2


def _reduced_helmich_paris(epmat, emmat, smat, mask, ldu, n_max, method,
                           off_tol=0.0):
    """algorithm=1 reduced solve (diaglib.f90:805-872).

    SVD smat = U1 S1 V1^T; scale by S1^{-1/2}; project ep/em; Cholesky both;
    C = Lm^T Lp; SVD C = U2 S2 V2^T; eigenvalues are the n_max smallest
    genuine singular values of C (ascending), eigenvector components
    xp = V1s Lm U2, xm = U1s Lp V2, scaled by 1/(sqrt(2) w).
    """
    dtype = smat.dtype
    sz = _pad_eye(smat, mask)
    u1, s1, vt1 = _hp_masked_svd(sz, mask, method, off_tol)
    inv_sqrt = 1.0 / jnp.sqrt(s1)
    u1s = u1 * inv_sqrt[None, :]      # columns scaled (diaglib.f90:818)
    vt1s = vt1 * inv_sqrt[:, None]    # rows scaled   (diaglib.f90:819)

    ep = _pad_eye(0.5 * (epmat + epmat.T), mask)
    em = _pad_eye(0.5 * (emmat + emmat.T), mask)
    ept = mm(vt1s, mmT(ep, vt1s))
    emt = mTm(u1s, mm(em, u1s))
    lp = reduced.cholesky(0.5 * (ept + ept.T), method)
    lm = reduced.cholesky(0.5 * (emt + emt.T), method)
    cmat = mTm(lm, lp)
    u2, s2, vt2 = _hp_masked_svd(cmat, mask, method, off_tol)

    # genuine singular values occupy the leading ldu slots in descending
    # order; the reference reads them from the bottom (smallest first)
    pos = jnp.clip(ldu - 1 - jnp.arange(n_max), 0, s2.shape[0] - 1)
    eig = jnp.take(s2, pos)
    xpt = mTm(vt1s, mm(lm, u2))
    xmt = mm(u1s, mmT(lp, vt2))
    scale = 1.0 / (jnp.sqrt(jnp.asarray(2.0, dtype)) * eig)
    up = jnp.take(xpt, pos, axis=1) * scale[None, :]
    um = jnp.take(xmt, pos, axis=1) * scale[None, :]
    return eig, up, um


def _bucketed_reduced(solve_fn, epmat, emmat, smat, mask, ldu, n_max,
                      lda_pad):
    """Run an (ep, em, s)-reduced solve on the smallest prefix bucket
    covering ``ldu`` (mask is a prefix mask; the genuine block is the
    leading ldu x ldu corner, so the bucketed solve is exact at L^3
    instead of lda_pad^3 — SURVEY.md §7 "bucket by active-count")."""
    from ..utils.masking import bucketed_switch

    def make(L):
        def run(_):
            eig, up, um = solve_fn(epmat[:L, :L], emmat[:L, :L],
                                   smat[:L, :L], mask[:L])
            padn = ((0, lda_pad - L), (0, 0))
            return eig, jnp.pad(up, padn), jnp.pad(um, padn)
        return run

    return bucketed_switch(make, ldu, lda_pad, 2 * n_max)


def _gram_update(gmat, left, right, ldu, n_act, n_max):
    """Update gmat = left @ right^T after n_act new rows were appended to
    both ``left`` and ``right`` at row ``ldu``: only the new rows and new
    columns change (O(n_act * n * L) instead of O(L^2 * n))."""
    from ..utils.masking import gather_rows, scatter_rows

    lblk = gather_rows(left, ldu, n_max, count=n_act)
    rblk = gather_rows(right, ldu, n_max, count=n_act)
    g = scatter_rows(gmat, mmT(lblk, right), ldu)
    return scatter_rows(g.T, mmT(rblk, left), ldu).T


class _CaslrState(NamedTuple):
    it: jax.Array
    vp: jax.Array
    vm: jax.Array
    lvp: jax.Array
    lvm: jax.Array
    bvp: jax.Array
    bvm: jax.Array
    # carried reduced Gram matrices, updated incrementally (only the new
    # rows/cols each iteration — the reference's own incremental a_red
    # idea, diaglib.f90:1691, applied to the LR drivers); epmat/emmat are
    # unused (zeros) in caslr_eff
    epmat: jax.Array
    emmat: jax.Array
    smat: jax.Array
    ldu: jax.Array
    n_act: jax.Array
    m_dim: jax.Array
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


def _lr_result(out, options):
    return LRSolverResult(
        eig=out.eig, evec=out.evec, ok=out.ok, n_iter=out.it,
        n_matvec=out.n_matvec, done=out.done,
        rms_history=out.rms_h, max_history=out.max_h, eig_history=out.eig_h,
        ortho_ok=out.ortho_ok,
    )


def caslr(apbmul, ambmul, spdmul, smdmul, lrprec, evec_guess,
          options: SolverOptions, *, algorithm: int = 0, key=None,
          sharding=None):
    """Casida LR solver with plain-orthonormal expansion spaces
    (caslr_driver, diaglib.f90:558-1022).

    ``algorithm`` selects the reduced solve: 0 = inverse pencil (the
    reference's default, utils.f90 i_alg=0) — computed here via its exact
    half-size Schur-complement reduction (see _reduced_inverse_pencil):
    HP needs two L x L SVDs per iteration, the reduction one L x L
    eigh_gen — or 1 = Helmich-Paris (SVD/Cholesky factorized,
    diaglib.f90:805-872), kept as the cross-check path.
    ``lrprec(w, rp, rm) -> (yp, ym)`` is called with the first active
    eigenvalue (diaglib.f90:953-954).  Returns eigenvalues w (ascending) and
    paired eigenvectors (Y, Z) rows of length 2n.
    """
    if algorithm not in (0, 1):
        raise ValueError("algorithm must be 0 or 1")
    return _caslr_impl(apbmul, ambmul, spdmul, smdmul, lrprec, evec_guess,
                       options, algorithm=algorithm, key=key,
                       sharding=sharding)


def _caslr_impl(apbmul, ambmul, spdmul, smdmul, lrprec, evec_guess,
                options: SolverOptions, *, algorithm: int = 0, key=None,
                sharding=None):
    from ..parallel.sharding import constrainers

    vec, _ = constrainers(sharding)
    n_targ, n_max = options.n_targ, options.n_max
    lda = options.dim_dav * n_max
    lda_pad = lda + n_max
    max_iter = options.max_iter
    vp0, vm0, n = _split_guess(evec_guess, n_max)
    dtype = vp0.dtype
    sqrtn = jnp.sqrt(jnp.asarray(n, dtype))
    tol_rms = jnp.asarray(options.tol, dtype)
    tol_max = jnp.asarray(options.tol_max, dtype)
    if key is None:
        key = jax.random.PRNGKey(0)
    kp, km = jax.random.split(key)

    vp0, _, _ = ortho_cd(_nonzero_or_random(vp0, kp))
    vm0, _, _ = ortho_cd(_nonzero_or_random(vm0, km))

    def cond(s: _CaslrState):
        return (~s.ok) & (s.it < max_iter)

    def body(s: _CaslrState):
        ldu_new = s.ldu + s.n_act
        amask = jnp.arange(n_max) < s.n_act

        def apply_new(op, space, target):
            blk = gather_rows(space, s.ldu, n_max, count=s.n_act)
            out = op(blk)
            out = jnp.where(amask[:, None], out, 0.0)
            return scatter_rows(target, out, s.ldu)

        lvp = apply_new(apbmul, s.vp, s.lvp)
        lvm = apply_new(ambmul, s.vm, s.lvm)
        bvm = apply_new(spdmul, s.vp, s.bvm)   # (S+D) vp -> bvm
        bvp = apply_new(smdmul, s.vm, s.bvp)   # (S-D) vm -> bvp
        n_matvec = s.n_matvec + 4 * s.n_act

        col_ok = prefix_mask(lda_pad, ldu_new)
        epmat = _gram_update(s.epmat, s.vp, lvp, s.ldu, s.n_act, n_max)
        emmat = _gram_update(s.emmat, s.vm, lvm, s.ldu, s.n_act, n_max)
        smat = _gram_update(s.smat, s.vm, bvm, s.ldu, s.n_act, n_max)

        # adaptive Jacobi off-norm target (see davidson.py note); the LR
        # eigenvalue mapping adds indirection, so keep an extra order of
        # margin like caslr_eff
        prev_rms = jnp.min(jnp.where(~s.done, s.rms, jnp.inf))
        off_tol = jnp.clip(1e-3 * prev_rms, 0.0, 1e-5)
        if algorithm == 0:
            solve = lambda ep, em, sz, m: _reduced_inverse_pencil(  # noqa: E731
                ep, em, sz, m, n_max, options.reduced_solver,
                off_tol=off_tol)
        else:
            solve = lambda ep, em, sz, m: _reduced_helmich_paris(  # noqa: E731
                ep, em, sz, m, ldu_new, n_max, options.reduced_solver,
                off_tol=off_tol)
        eig, up, um = _bucketed_reduced(solve, epmat, emmat, smat, col_ok,
                                        ldu_new, n_max, lda_pad)

        eigp = mTm(up, s.vp)
        eigm = mTm(um, s.vm)
        evec = _combine(eigp, eigm)

        rp = mTm(up, lvp) - eig[:, None] * mTm(um, bvp)
        rm = mTm(um, lvm) - eig[:, None] * mTm(up, bvm)

        active = (~s.done) & (jnp.arange(n_max) < n_targ)
        rms_new = (jnp.linalg.norm(rp, axis=1)
                   + jnp.linalg.norm(rm, axis=1)) / sqrtn
        max_new = jnp.max(jnp.abs(rp), axis=1) + jnp.max(jnp.abs(rm), axis=1)
        rms = jnp.where(active, rms_new, s.rms)
        rmx = jnp.where(active, max_new, s.rmx)

        conv = (rms < tol_rms) & (rmx < tol_max) & (s.it > 0)
        done = prefix_lock(s.done, conv, n_targ)
        ok = jnp.all(jnp.where(jnp.arange(n_max) < n_targ, done, True))

        eig_h = s.eig_h.at[s.it].set(eig)
        rms_h = s.rms_h.at[s.it].set(rms)
        max_h = s.max_h.at[s.it].set(rmx)
        if options.verbose:
            from ..reporting import inflight_progress
            inflight_progress("caslr", s.it, s.n_act, eig_h[s.it], rms, rmx)


        n_frozen = jnp.sum(done, dtype=jnp.int32)
        n_act_new = (n_max - n_frozen).astype(jnp.int32)

        def expand(_):
            umask = jnp.arange(n_max) < n_act_new
            rpb = gather_rows(rp, n_frozen, n_max, count=n_act_new)
            rmb = gather_rows(rm, n_frozen, n_max, count=n_act_new)
            yp, ym = lrprec(eig[n_frozen], rpb, rmb)
            yp = jnp.where(umask[:, None], yp, 0.0)
            ym = jnp.where(umask[:, None], ym, 0.0)
            yp, p_done = ortho_vs_x(s.vp, yp, xmask=col_ok, umask=umask)
            ym, m_done = ortho_vs_x(s.vm, ym, xmask=col_ok, umask=umask)
            return (scatter_rows(s.vp, yp, ldu_new),
                    scatter_rows(s.vm, ym, ldu_new),
                    lvp, lvm, bvp, bvm,
                    ldu_new, n_act_new, s.m_dim + 1,
                    s.ortho_ok & p_done & m_done)

        def restart(_):
            vpn, _, ok_p = ortho_cd(eigp)
            vmn, _, ok_m = ortho_cd(eigm)
            z = jnp.zeros_like(s.vp)
            return (scatter_rows(z, vpn, 0), scatter_rows(z, vmn, 0),
                    z, z, z, z,
                    jnp.asarray(0, jnp.int32), jnp.asarray(n_max, jnp.int32),
                    jnp.asarray(1, jnp.int32), s.ortho_ok & ok_p & ok_m)

        def finish(_):
            return (s.vp, s.vm, lvp, lvm, bvp, bvm, ldu_new, s.n_act, s.m_dim,
                    s.ortho_ok)

        (vp2, vm2, lvp2, lvm2, bvp2, bvm2, ldu2, n_act2, m_dim2,
         ortho_ok2) = jax.lax.cond(
            ok, finish,
            lambda _: jax.lax.cond(s.m_dim < options.dim_dav, expand,
                                   restart, None),
            None,
        )

        return _CaslrState(
            it=s.it + 1, vp=vp2, vm=vm2, lvp=lvp2, lvm=lvm2, bvp=bvp2,
            bvm=bvm2, epmat=epmat, emmat=emmat, smat=smat,
            ldu=ldu2, n_act=n_act2, m_dim=m_dim2, eig=eig,
            evec=evec, done=done, rms=rms, rmx=rmx, ok=ok,
            ortho_ok=ortho_ok2, n_matvec=n_matvec,
            eig_h=eig_h, rms_h=rms_h, max_h=max_h,
        )

    z0 = vec(jnp.zeros((lda_pad, n), dtype))
    init = _CaslrState(
        it=jnp.asarray(0, jnp.int32),
        vp=vec(scatter_rows(z0, vp0, 0)), vm=vec(scatter_rows(z0, vm0, 0)),
        lvp=z0, lvm=z0, bvp=z0, bvm=z0,
        epmat=jnp.zeros((lda_pad, lda_pad), dtype),
        emmat=jnp.zeros((lda_pad, lda_pad), dtype),
        smat=jnp.zeros((lda_pad, lda_pad), dtype),
        ldu=jnp.asarray(0, jnp.int32),
        n_act=jnp.asarray(n_max, jnp.int32),
        m_dim=jnp.asarray(1, jnp.int32),
        eig=jnp.zeros((n_max,), dtype),
        evec=vec(jnp.zeros((n_max, 2 * n), dtype)),
        done=jnp.zeros((n_max,), bool),
        rms=jnp.full((n_max,), jnp.inf, dtype),
        rmx=jnp.full((n_max,), jnp.inf, dtype),
        ok=jnp.asarray(False),
        ortho_ok=jnp.asarray(True),
        n_matvec=jnp.asarray(0, jnp.int32),
        eig_h=jnp.zeros((max_iter, n_max), dtype),
        rms_h=jnp.full((max_iter, n_max), jnp.inf, dtype),
        max_h=jnp.full((max_iter, n_max), jnp.inf, dtype),
    )

    out = jax.lax.while_loop(cond, body, init)
    return _lr_result(out, options)


def caslr_eff(apbmul, ambmul, spdmul, smdmul, lrprec, evec_guess,
              options: SolverOptions, *, key=None, sharding=None):
    """Efficient Casida solver with (A±B)-orthonormal expansion vectors
    (caslr_eff_driver, diaglib.f90:1024-1481).

    The reduced problem is the half-size symmetric ``s^T s u+ = (1/w)^2 u+``;
    only spdmul/smdmul run in the loop, apbmul/ambmul only when expanding.
    ``lrprec`` is called with the internal 1/w (diaglib.f90:1406-1407).
    """
    return _caslr_eff_impl(apbmul, ambmul, spdmul, smdmul, lrprec,
                           evec_guess, options, key=key, sharding=sharding)


def _caslr_eff_impl(apbmul, ambmul, spdmul, smdmul, lrprec, evec_guess,
                    options: SolverOptions, *, key=None, sharding=None):
    from ..parallel.sharding import constrainers

    vec, _ = constrainers(sharding)
    n_targ, n_max = options.n_targ, options.n_max
    lda = options.dim_dav * n_max
    lda_pad = lda + n_max
    max_iter = options.max_iter
    vp0, vm0, n = _split_guess(evec_guess, n_max)
    dtype = vp0.dtype
    sqrtn = jnp.sqrt(jnp.asarray(n, dtype))
    sqrt2 = jnp.sqrt(jnp.asarray(2.0, dtype))
    tol_rms = jnp.asarray(options.tol, dtype)
    tol_max = jnp.asarray(options.tol_max, dtype)
    if key is None:
        key = jax.random.PRNGKey(0)
    kp, km = jax.random.split(key)

    def metric_ortho(v, op, mask=None):
        """B-orthonormalize v in the (A±B) metric; the third element is
        b_ortho's ok flag (False when the SVD rescue replaced a failed
        metric Cholesky — the reference hard-stops there,
        diaglib.f90:3131-3138)."""
        lv = op(v)
        if mask is not None:
            lv = jnp.where(mask[:, None], lv, 0.0)
        return b_ortho(v, lv, mask)

    vp0, lvp0, bok_p0 = metric_ortho(_nonzero_or_random(vp0, kp), apbmul)
    vm0, lvm0, bok_m0 = metric_ortho(_nonzero_or_random(vm0, km), ambmul)

    def cond(s: _CaslrState):
        return (~s.ok) & (s.it < max_iter)

    def body(s: _CaslrState):
        ldu_new = s.ldu + s.n_act
        amask = jnp.arange(n_max) < s.n_act

        def apply_new(op, space, target):
            blk = gather_rows(space, s.ldu, n_max, count=s.n_act)
            out = op(blk)
            out = jnp.where(amask[:, None], out, 0.0)
            return scatter_rows(target, out, s.ldu)

        bvm = apply_new(spdmul, s.vp, s.bvm)
        bvp = apply_new(smdmul, s.vm, s.bvp)
        n_matvec = s.n_matvec + 2 * s.n_act

        col_ok = prefix_mask(lda_pad, ldu_new)
        smat = _pad_zero(
            _gram_update(s.smat, s.vm, bvm, s.ldu, s.n_act, n_max), col_ok)

        # reduced solve on the smallest prefix bucket covering ldu_new
        # (genuine block is the leading corner; L^3 instead of lda_pad^3)
        def reduced_at(L):
            def run(_):
                s_l = smat[:L, :L]
                sts = mTm(s_l, s_l)
                # pad with a large negative diagonal so the genuine (>=0)
                # spectrum occupies the trailing ascending slots (we need
                # the LARGEST here, diaglib.f90:1309-1312)
                pad = -(jnp.max(jnp.sum(jnp.abs(sts), axis=1)) + 1.0)
                sts = sts + jnp.diag(jnp.where(col_ok[:L], 0.0, pad))
                # adaptive Jacobi off-norm target (davidson.py note); the
                # s^T s spectrum maps to eigenvalues via sqrt+invert, so
                # use an extra order of margin vs the symmetric drivers
                prev_rms = jnp.min(jnp.where(~s.done, s.rms, jnp.inf))
                off_tol = jnp.clip(1e-3 * prev_rms, 0.0, 1e-5)
                e_red, c_full = reduced.eigh(sts, options.reduced_solver,
                                             off_tol=off_tol)
                iw = jnp.sqrt(jnp.abs(e_red[::-1][:n_max]))  # 1/w, descending
                u = jnp.pad(c_full[:, ::-1][:, :n_max],
                            ((0, lda_pad - L), (0, 0)))
                return iw, u
            return run

        from ..utils.masking import bucketed_switch
        inv_w, up = bucketed_switch(reduced_at, ldu_new, lda_pad, 2 * n_max)
        um = mm(smat, up) / inv_w[None, :]

        eigp = mTm(up, s.vp)
        eigm = mTm(um, s.vm)
        evec = _combine(eigp, eigm)

        rp = mTm(um, bvp) - inv_w[:, None] * mTm(up, s.lvp)
        rm = mTm(up, bvm) - inv_w[:, None] * mTm(um, s.lvm)

        active = (~s.done) & (jnp.arange(n_max) < n_targ)
        scale = inv_w * sqrt2
        rms_new = (jnp.linalg.norm(rp, axis=1)
                   + jnp.linalg.norm(rm, axis=1)) / (scale * sqrtn)
        max_new = (jnp.max(jnp.abs(rp), axis=1)
                   + jnp.max(jnp.abs(rm), axis=1)) / scale
        rms = jnp.where(active, rms_new, s.rms)
        rmx = jnp.where(active, max_new, s.rmx)

        conv = (rms < tol_rms) & (rmx < tol_max) & (s.it > 0)
        done = prefix_lock(s.done, conv, n_targ)
        ok = jnp.all(jnp.where(jnp.arange(n_max) < n_targ, done, True))

        eig_h = s.eig_h.at[s.it].set(1.0 / inv_w)
        rms_h = s.rms_h.at[s.it].set(rms)
        max_h = s.max_h.at[s.it].set(rmx)
        if options.verbose:
            from ..reporting import inflight_progress
            inflight_progress("caslr_eff", s.it, s.n_act, eig_h[s.it],
                              rms, rmx)


        n_frozen = jnp.sum(done, dtype=jnp.int32)
        n_act_new = (n_max - n_frozen).astype(jnp.int32)

        def expand(_):
            umask = jnp.arange(n_max) < n_act_new
            rpb = gather_rows(rp, n_frozen, n_max, count=n_act_new)
            rmb = gather_rows(rm, n_frozen, n_max, count=n_act_new)
            yp, ym = lrprec(inv_w[n_frozen], rpb, rmb)
            yp = jnp.where(umask[:, None], yp, 0.0)
            ym = jnp.where(umask[:, None], ym, 0.0)
            yp, p_done = b_ortho_vs_x(s.vp, s.lvp, yp, xmask=col_ok,
                                      umask=umask)
            lyp = apbmul(yp)
            lyp = jnp.where(umask[:, None], lyp, 0.0)
            yp, lyp, bok_p = b_ortho(yp, lyp, umask)
            p_done = p_done & bok_p
            ym, m_done = b_ortho_vs_x(s.vm, s.lvm, ym, xmask=col_ok,
                                      umask=umask)
            lym = ambmul(ym)
            lym = jnp.where(umask[:, None], lym, 0.0)
            ym, lym, bok_m = b_ortho(ym, lym, umask)
            m_done = m_done & bok_m
            return (scatter_rows(s.vp, yp, ldu_new),
                    scatter_rows(s.vm, ym, ldu_new),
                    scatter_rows(s.lvp, lyp, ldu_new),
                    scatter_rows(s.lvm, lym, ldu_new),
                    bvp, bvm, ldu_new, n_act_new, s.m_dim + 1,
                    s.ortho_ok & p_done & m_done)

        def restart(_):
            vpn, lvpn, bok_p = metric_ortho(eigp, apbmul)
            vmn, lvmn, bok_m = metric_ortho(eigm, ambmul)
            z = jnp.zeros_like(s.vp)
            return (scatter_rows(z, vpn, 0), scatter_rows(z, vmn, 0),
                    scatter_rows(z, lvpn, 0), scatter_rows(z, lvmn, 0),
                    z, z,
                    jnp.asarray(0, jnp.int32), jnp.asarray(n_max, jnp.int32),
                    jnp.asarray(1, jnp.int32),
                    s.ortho_ok & bok_p & bok_m)

        def finish(_):
            return (s.vp, s.vm, s.lvp, s.lvm, bvp, bvm, ldu_new, s.n_act,
                    s.m_dim, s.ortho_ok)

        (vp2, vm2, lvp2, lvm2, bvp2, bvm2, ldu2, n_act2, m_dim2,
         ortho_ok2) = jax.lax.cond(
            ok, finish,
            lambda _: jax.lax.cond(s.m_dim < options.dim_dav, expand,
                                   restart, None),
            None,
        )

        return _CaslrState(
            it=s.it + 1, vp=vp2, vm=vm2, lvp=lvp2, lvm=lvm2, bvp=bvp2,
            bvm=bvm2, epmat=s.epmat, emmat=s.emmat, smat=smat,
            ldu=ldu2, n_act=n_act2, m_dim=m_dim2,
            eig=1.0 / inv_w,  # report w (the reference inverts on exit)
            evec=evec, done=done, rms=rms, rmx=rmx, ok=ok,
            ortho_ok=ortho_ok2, n_matvec=n_matvec,
            eig_h=eig_h, rms_h=rms_h, max_h=max_h,
        )

    z0 = vec(jnp.zeros((lda_pad, n), dtype))
    init = _CaslrState(
        it=jnp.asarray(0, jnp.int32),
        vp=vec(scatter_rows(z0, vp0, 0)), vm=vec(scatter_rows(z0, vm0, 0)),
        lvp=vec(scatter_rows(z0, lvp0, 0)), lvm=vec(scatter_rows(z0, lvm0, 0)),
        bvp=z0, bvm=z0,
        epmat=jnp.zeros((lda_pad, lda_pad), dtype),
        emmat=jnp.zeros((lda_pad, lda_pad), dtype),
        smat=jnp.zeros((lda_pad, lda_pad), dtype),
        ldu=jnp.asarray(0, jnp.int32),
        n_act=jnp.asarray(n_max, jnp.int32),
        m_dim=jnp.asarray(1, jnp.int32),
        eig=jnp.zeros((n_max,), dtype),
        evec=vec(jnp.zeros((n_max, 2 * n), dtype)),
        done=jnp.zeros((n_max,), bool),
        rms=jnp.full((n_max,), jnp.inf, dtype),
        rmx=jnp.full((n_max,), jnp.inf, dtype),
        ok=jnp.asarray(False),
        ortho_ok=bok_p0 & bok_m0,
        n_matvec=jnp.asarray(2 * n_max, jnp.int32),  # prologue apb/amb
        eig_h=jnp.zeros((max_iter, n_max), dtype),
        rms_h=jnp.full((max_iter, n_max), jnp.inf, dtype),
        max_h=jnp.full((max_iter, n_max), jnp.inf, dtype),
    )

    out = jax.lax.while_loop(cond, body, init)
    return _lr_result(out, options)


def _hp_masked_svd(a, mask, method, off_tol):
    """masked_svd for the Helmich-Paris reduced factors, with the Jacobi
    route forced TWO-SIDED.

    Under an emulated-f64 arithmetic the one-sided Hestenes SVD
    mis-converged on the HP chain's factors (the toy HP protocol failed
    to converge in 100 iterations), while the two-sided augmented Jacobi
    converged in the reference iteration count (16); the same one-sided
    code converges on CPU.  Only the two SVDs of this path are rerouted
    when ``method`` is "jacobi"; other methods use :func:`masked_svd`.
    """
    from ..utils import reduced

    if reduced.resolve(method) != "jacobi":
        return masked_svd(a, mask, method, off_tol=off_tol)
    from ..utils.jacobi import jacobi_svd, rank_argsort

    # identical padding/reordering contract as utils.masking.masked_svd
    outer = mask[:, None] & mask[None, :]
    a_v = jnp.where(outer, a, 0.0)
    pad = jnp.sqrt(jnp.sum(a_v * a_v)) + 2.0
    a_m = a_v + jnp.diag(jnp.where(mask, 0.0, pad))
    u, s, vt = jacobi_svd(a_m, off_tol=off_tol)
    score = jnp.sum(jnp.where(mask[:, None], u, 0.0) ** 2, axis=0)
    order = rank_argsort(jnp.where(score > 0.5, 0.0, 1.0))
    return u[:, order], s[order], vt[order, :]
