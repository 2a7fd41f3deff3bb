"""Numerically hardened orthogonalization kernels (masked).

Re-designs the reference's orthogonalization layer (diaglib.f90:3049-3663)
for XLA: every routine is a pure function over *row-major* vector blocks
``U: (k, n)`` (rows are vectors) with a boolean row-validity ``mask``; masked
rows are kept exactly zero throughout.  All data-dependent retry/refinement
loops (Cholesky level-shift ladder, iterative re-orthogonalization) run inside
``lax.while_loop`` so the whole solver stays jit-compiled end to end.

Components and their reference counterparts:

* ``norm_est``      — diaglib.f90:3447-3479 (triangular norm bound).
* ``ortho_cd``      — diaglib.f90:3185-3341 (shifted Cholesky + iterative
                      refinement + growth-factor error model).
* ``ortho_qr``      — diaglib.f90:3052-3092 (QR; fallback path).  Note the
                      reference's second-set transform is documented but not
                      implemented there (its body never touches ``w``); here
                      the returned transform is applied correctly when asked.
* ``ortho_vs_x``    — diaglib.f90:3481-3574.
* ``b_ortho``       — diaglib.f90:3094-3183 (Cholesky branch; the disabled
                      ``use_svd`` debug branch is available as
                      ``b_ortho_svd``).
* ``b_ortho_vs_x``  — diaglib.f90:3576-3663.
* ``biortho_vs_x``  — diaglib.f90:3343-3393.
* ``svd_biortho``   — diaglib.f90:3395-3445.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from ..utils.masking import masked_cholesky, masked_svd
from ..utils.mm import mm, mTm, mmT

__all__ = [
    "norm_est",
    "ortho_cd",
    "ortho_qr",
    "ortho_vs_x",
    "b_ortho",
    "b_ortho_svd",
    "b_ortho_vs_x",
    "biortho_vs_x",
    "svd_biortho",
]

_MAXIT = 10
_MAXIT_BIORTHO = 20


def _eps(dtype):
    return jnp.asarray(jnp.finfo(dtype).eps, dtype)


def _tol_ortho(dtype):
    return 2.0 * _eps(dtype)


def _rowmask(mask, k):
    if mask is None:
        return jnp.ones((k,), dtype=bool)
    return mask


def norm_est(L, mask=None):
    """Cheap norm bound of a lower-triangular matrix (diaglib.f90:3447-3479).

    ||L|| <= max_i |L_ii| + ||strict lower||_F.  Masked rows/cols excluded.
    """
    k = L.shape[0]
    mask = _rowmask(mask, k)
    diag = jnp.abs(jnp.diagonal(L))
    diag_norm = jnp.max(jnp.where(mask, diag, 0.0))
    lower = jnp.tril(L, k=-1)
    outer = mask[:, None] & mask[None, :]
    od_norm = jnp.sqrt(jnp.sum(jnp.where(outer, lower, 0.0) ** 2))
    return diag_norm + od_norm


class _CDState(NamedTuple):
    u: jax.Array
    growth: jax.Array
    it: jax.Array
    done: jax.Array
    ok: jax.Array
    prev_rcond: jax.Array


def _shifted_cholesky(metric, mask, unorm, dtype):
    """Cholesky with the level-shift retry ladder (diaglib.f90:3265-3295).

    On failure, add ``shift = max(eps*alpha*||U||, tol_ortho)`` to the valid
    diagonal, with alpha = 100 and growing 10x per retry, up to 10 retries.
    Returns (L, failed).
    """
    L0, failed0 = masked_cholesky(metric, mask)

    def cond(c):
        _, failed, _, it = c
        return failed & (it < _MAXIT)

    def body(c):
        _, _, alpha, it = c
        shift = jnp.maximum(_eps(dtype) * alpha * unorm, _tol_ortho(dtype))
        shifted = metric + jnp.diag(jnp.where(mask, shift, 0.0))
        L, failed = masked_cholesky(shifted, mask)
        return (L, failed, alpha * 10.0, it + 1)

    alpha0 = jnp.asarray(100.0, dtype)
    L, failed, _, _ = jax.lax.while_loop(
        cond, body, (L0, failed0, alpha0, jnp.asarray(0, jnp.int32))
    )
    return L, failed


def ortho_cd(u, mask=None, max_iter: int = _MAXIT):
    """Cholesky orthonormalization with level shifting and refinement.

    Reference: diaglib.f90:3185-3341.  Returns ``(u_ortho, growth, ok)``.
    ``growth`` is the accumulated ||L^-1|| product used by the *_vs_x callers
    to bound the orthogonality error they re-introduced; ``ok`` is False if
    the refinement loop did not converge in ``max_iter`` macro-iterations
    (callers then fall back to QR, diaglib.f90:3533-3534).
    """
    k, n = u.shape
    dtype = u.dtype
    mask = _rowmask(mask, k)
    eye = jnp.eye(k, dtype=dtype)

    def cond(s: _CDState):
        return (~s.done) & (s.it < max_iter)

    def body(s: _CDState):
        uu = s.u
        metric = mmT(uu, uu)
        unorm = jnp.sqrt(jnp.sum(uu * uu))
        L, failed = _shifted_cholesky(metric, mask, unorm, dtype)
        # if the shift ladder itself failed, bail out with ok=False
        linv = solve_triangular(L, eye, lower=True)
        l_norm = norm_est(L, mask)
        linv_norm = norm_est(linv, mask)
        rcond = l_norm * linv_norm
        growth = s.growth * linv_norm
        u_new = mm(linv, uu)
        error = _eps(dtype) * rcond * rcond
        converged = error < _tol_ortho(dtype)
        # each refinement pass squares the orthogonality error, so rcond
        # must drop sharply pass over pass; a stalled rcond means the block
        # is (numerically) rank deficient and can NEVER converge here —
        # bail to the QR fallback instead of burning max_iter passes
        # (deficient blocks appear routinely near solver convergence when
        # residuals of locked-adjacent roots degenerate)
        stalled = (s.it > 0) & (rcond >= 0.5 * s.prev_rcond) & (~converged)
        done = converged | failed | stalled
        ok = converged
        u_out = jnp.where(failed, uu, u_new)
        growth = jnp.where(failed, s.growth, growth)
        return _CDState(u_out, growth, s.it + 1, done, ok, rcond)

    init = _CDState(
        u,
        jnp.asarray(1.0, dtype),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(False),
        jnp.asarray(False),
        jnp.asarray(jnp.inf, dtype),
    )
    out = jax.lax.while_loop(cond, body, init)
    ok = out.ok & out.done  # ran to convergence, no failure/stall
    return out.u, out.growth, ok


def ortho_qr(u, mask=None, extra=None):
    """QR orthonormalization of masked rows (diaglib.f90:3052-3092).

    Valid rows are (stably) permuted to the front, so the Q factor of the
    leading columns depends only on them; masked rows come back as zeros.
    If ``extra`` (e.g. A@U with the same masked rows) is given, the same
    linear transform R^{-1} is applied to it — this implements what the
    reference's docstring promises (diaglib.f90:3058-3064) but its body omits.
    """
    k, n = u.shape
    mask = _rowmask(mask, k)
    perm = jnp.argsort(~mask, stable=True)
    # inverse permutation by a scatter: an argsort of ``perm`` trips XLA
    # GPU's permutation-sort simplifier under x64 (s32/s64 mismatch)
    inv_perm = jnp.zeros_like(perm).at[perm].set(
        jnp.arange(k, dtype=perm.dtype), unique_indices=True)
    u_p = jnp.take(u, perm, axis=0)
    # substitute masked (now trailing) rows with unit vectors so QR stays
    # well-posed; they never influence the leading (valid) Q columns.
    basis = jax.nn.one_hot(jnp.arange(k) % n, n, dtype=u.dtype)
    mask_p = jnp.take(mask, perm)
    u_p = jnp.where(mask_p[:, None], u_p, basis)
    q, r = jnp.linalg.qr(u_p.T, mode="reduced")  # (n, k), (k, k)
    q_rows = q.T
    q_rows = jnp.where(mask_p[:, None], q_rows, 0.0)
    out = jnp.take(q_rows, inv_perm, axis=0)
    if extra is None:
        return out
    e_p = jnp.take(extra, perm, axis=0)
    e_rows = solve_triangular(r, e_p, lower=False, trans=1).astype(u.dtype)
    e_rows = jnp.where(mask_p[:, None], e_rows, 0.0)
    return out, jnp.take(e_rows, inv_perm, axis=0)


def _ortho_or_qr(u, mask):
    """ortho_cd with QR fallback (diaglib.f90:3533-3549).

    Returns (u, growth, cd_ok): when ortho_cd fails, u comes from QR and
    callers must compute the explicit overlap to test convergence.  The QR
    branch sits behind a ``lax.cond`` so the expensive full-height
    Householder QR (far costlier than the Cholesky path on a (k, n)
    block) only runs when the shift ladder actually failed — like the
    reference, where the fallback is a rarely-taken error path.
    """
    u_cd, growth, ok = ortho_cd(u, mask)
    u_out = jax.lax.cond(
        ok,
        lambda uu: u_cd,
        lambda uu: ortho_qr(uu, mask),
        u,
    )
    return u_out, growth, ok


class _VsXState(NamedTuple):
    u: jax.Array
    it: jax.Array
    done: jax.Array
    ok: jax.Array


def _iterate_vs_x(project, x_for_overlap, u, umask, max_iter):
    """Shared loop of (b_)ortho_vs_x: project out X, re-orthonormalize,
    repeat until the (estimated) overlap with X is below 2*eps."""
    dtype = u.dtype

    def cond(s: _VsXState):
        return (~s.done) & (s.it < max_iter)

    def body(s: _VsXState):
        uu = project(s.u)
        uu, growth, cd_ok = _ortho_or_qr(uu, umask)
        # overlap computed as (u x^T): same Frobenius norm as (x u^T)
        overlap = mmT(uu, x_for_overlap)
        explicit = jnp.sqrt(jnp.sum(overlap * overlap))
        xu_norm = jnp.where(cd_ok, growth * _eps(dtype), explicit)
        done = xu_norm < _tol_ortho(dtype)
        return _VsXState(uu, s.it + 1, done, jnp.asarray(True))

    u0, growth0, cd_ok0 = _ortho_or_qr(u, umask)
    init = _VsXState(u0, jnp.asarray(0, jnp.int32), jnp.asarray(False), jnp.asarray(False))
    out = jax.lax.while_loop(cond, body, init)
    return out.u, out.done


def ortho_vs_x(x, u, xmask=None, umask=None, max_iter: int = _MAXIT):
    """Orthogonalize block u against orthonormal x, then orthonormalize u.

    Reference: diaglib.f90:3481-3574.  Iterates the projection
    ``u <- u - (u x^T) x`` + orthonormalization until ||x u^T|| < 2*eps,
    estimating the overlap from ortho_cd's growth factor when available.
    Masked rows of x and u are zero and stay zero.
    """
    xmask = _rowmask(xmask, x.shape[0])
    umask = _rowmask(umask, u.shape[0])
    xm = jnp.where(xmask[:, None], x, 0.0)

    def project(uu):
        return uu - mm(mmT(uu, xm), xm)

    u_out, done = _iterate_vs_x(project, xm, u, umask, max_iter)
    return u_out, done


def b_ortho(u, bu, mask=None):
    """B-orthonormalize u given bu = B u (diaglib.f90:3094-3183).

    metric = u bu^T is Cholesky-factored; L^{-1} is applied to both u and
    bu.  When the Cholesky fails (numerically rank-deficient block — e.g.
    near-resonant preconditioned directions), the reference's disabled
    ``use_svd`` branch (diaglib.f90:3116-3168) takes over as the rescue
    path: metric^{-1/2} with singular directions below tol dropped.  The
    reference would hard-stop here (diaglib.f90:3131-3138); the SVD branch
    keeps the basis usable, and the returned ``ok`` flag (False when the
    rescue fired) lets every caller AND the event into the solver-level
    ``ortho_ok`` so a metric breakdown is never silent.

    Returns ``(u, bu, ok)``.
    """
    k = u.shape[0]
    mask = _rowmask(mask, k)
    # row pre-normalization: exact (diagonal scaling never changes the
    # span) and it keeps the metric O(1) even when the rows arrive with
    # wildly different norms (e.g. resonance-amplified preconditioned
    # residuals), which is the difference between a clean Cholesky and a
    # breakdown at large n
    norms = jnp.linalg.norm(u, axis=1)
    inv = jnp.where(norms > 0.0, 1.0 / jnp.where(norms > 0.0, norms, 1.0),
                    1.0)
    u = u * inv[:, None]
    bu = bu * inv[:, None]
    metric = mmT(u, bu)
    L, failed = masked_cholesky(metric, mask)

    def chol_path(_):
        u_new = solve_triangular(L, u, lower=True)
        bu_new = solve_triangular(L, bu, lower=True)
        return u_new, bu_new

    def svd_path(_):
        return b_ortho_svd(u, bu, mask)

    u_new, bu_new = jax.lax.cond(failed, svd_path, chol_path, None)
    u_new = jnp.where(mask[:, None], u_new, 0.0)
    bu_new = jnp.where(mask[:, None], bu_new, 0.0)
    return u_new, bu_new, ~failed


def b_ortho_svd(u, bu, mask=None, tol_svd: float = 1.0e-5):
    """The reference's disabled SVD branch of b_ortho (diaglib.f90:3127-3168):
    apply metric^{-1/2}, dropping singular directions below ``tol_svd``
    RELATIVE to the largest singular value (the reference's absolute 1e-5
    encodes the same intent for its O(1)-normalized metrics; an absolute
    cut on a metric with 1e12-scale singular values would keep pure-noise
    directions and amplify them by 1/sqrt(s))."""
    k = u.shape[0]
    mask = _rowmask(mask, k)
    metric = mmT(u, bu)
    uu, s, vt = masked_svd(metric, mask)
    s_floor = tol_svd * jnp.max(jnp.where(mask, s, 0.0))
    s_inv = jnp.where(s > s_floor, 1.0 / jnp.sqrt(jnp.maximum(s, s_floor)),
                      0.0)
    m_inv_half = uu @ (s_inv[:, None] * vt)
    u_new = mTm(m_inv_half, u)
    bu_new = mTm(m_inv_half, bu)
    u_new = jnp.where(mask[:, None], u_new, 0.0)
    bu_new = jnp.where(mask[:, None], bu_new, 0.0)
    return u_new, bu_new


def b_ortho_vs_x(x, bx, u, xmask=None, umask=None, max_iter: int = _MAXIT):
    """B-orthogonalize u against x (metric overlap bx^T u), then
    orthonormalize u; iterate (diaglib.f90:3576-3663)."""
    xmask = _rowmask(xmask, x.shape[0])
    umask = _rowmask(umask, u.shape[0])
    xm = jnp.where(xmask[:, None], x, 0.0)
    bxm = jnp.where(xmask[:, None], bx, 0.0)

    def project(uu):
        return uu - mm(mmT(uu, bxm), xm)

    u_out, done = _iterate_vs_x(project, bxm, u, umask, max_iter)
    return u_out, done


def svd_biortho(u_l, u_r, mask=None):
    """Biorthonormalize (u_l, u_r) via the SVD of their overlap
    (diaglib.f90:3395-3445): u_l <- U^T u_l / sqrt(s), u_r <- V^T u_r / sqrt(s),
    giving u_l u_r^T = I on the valid block."""
    k = u_l.shape[0]
    mask = _rowmask(mask, k)
    over = mmT(u_l, u_r)
    uu, s, vt = masked_svd(over, mask)
    inv_sqrt = 1.0 / jnp.sqrt(s)
    u_l_new = inv_sqrt[:, None] * mTm(uu, u_l)
    u_r_new = inv_sqrt[:, None] * mm(vt, u_r)
    u_l_new = jnp.where(mask[:, None], u_l_new, 0.0)
    u_r_new = jnp.where(mask[:, None], u_r_new, 0.0)
    return u_l_new, u_r_new


class _BiState(NamedTuple):
    ul: jax.Array
    ur: jax.Array
    it: jax.Array
    done: jax.Array


def biortho_vs_x(xl, xr, ul, ur, xmask=None, umask=None,
                 max_iter: int = _MAXIT_BIORTHO):
    """Biorthogonalize (ul, ur) against (xr, xl), orthonormalize each and
    iterate until the overlap error is tight (diaglib.f90:3343-3393);
    finish with svd_biortho.  Returns ``(ul, ur, done)``.

    When ortho_cd fails/stalls on either block, the QR fallback fires and
    the convergence test switches to the explicit ||x u^T|| overlap
    (growth would be stale on that branch) — the same ladder every other
    *_vs_x routine uses (diaglib.f90:3533-3549).
    """
    xmask = _rowmask(xmask, xl.shape[0])
    umask = _rowmask(umask, ul.shape[0])
    xlm = jnp.where(xmask[:, None], xl, 0.0)
    xrm = jnp.where(xmask[:, None], xr, 0.0)
    dtype = ul.dtype

    def _overlap_err(x_for_overlap, uu, growth, cd_ok):
        overlap = mmT(x_for_overlap, uu)
        explicit = jnp.sqrt(jnp.sum(overlap * overlap))
        return jnp.where(cd_ok, growth * _eps(dtype), explicit)

    def cond(s: _BiState):
        return (~s.done) & (s.it < max_iter)

    def body(s: _BiState):
        ur_ = s.ur - mm(mmT(s.ur, xlm), xrm)
        ul_ = s.ul - mm(mmT(s.ul, xrm), xlm)
        ul_, g_l, ok_l = _ortho_or_qr(ul_, umask)
        ur_, g_r, ok_r = _ortho_or_qr(ur_, umask)
        n1 = _overlap_err(xrm, ul_, g_l, ok_l)
        n2 = _overlap_err(xlm, ur_, g_r, ok_r)
        done = (n1 < _tol_ortho(dtype)) & (n2 < _tol_ortho(dtype))
        return _BiState(ul_, ur_, s.it + 1, done)

    init = _BiState(ul, ur, jnp.asarray(0, jnp.int32), jnp.asarray(False))
    out = jax.lax.while_loop(cond, body, init)
    ul_f, ur_f = svd_biortho(out.ul, out.ur, umask)
    return ul_f, ur_f, out.done
