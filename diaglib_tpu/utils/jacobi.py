"""Compile-friendly on-device symmetric eigensolver (cyclic Jacobi).

Why this exists: the reduced matrices of every driver are small (a few
hundred squared).  Classic cyclic Jacobi with a static round-robin
ordering compiles to a tiny fixed program (a scan over rotation rounds
inside a sweep loop) whatever the matrix dimension, runs in O(L^3) flops
per sweep with O(L^2) work per round, and is backward stable with
excellent relative accuracy.  It is the ``reduced_solver="jacobi"`` route;
the default route is ``jnp.linalg`` (utils/reduced.py), and which one is
faster on a device is a measurement (ROADMAP C4).

The SVD is obtained from the Jacobi eigendecomposition of the symmetric
augmented matrix [[0, A^T], [A, 0]] whose positive eigenpairs are the
singular triplets.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .mm import mm, mTm

__all__ = ["jacobi_eigh", "jacobi_svd", "jacobi_svd_onesided",
           "rank_argsort"]


def rank_argsort(w, descending: bool = False):
    """Stable argsort of a small 1-D array without a sort HLO.

    An O(L^2) comparison matrix is free at reduced-matrix sizes and lowers
    to plain vector ops, where a sort HLO inside big loop bodies adds
    compile cost.
    """
    L = w.shape[0]
    idx = jnp.arange(L)
    if descending:
        key_lt = w[None, :] > w[:, None]
    else:
        key_lt = w[None, :] < w[:, None]
    before = key_lt | ((w[None, :] == w[:, None]) & (idx[None, :] < idx[:, None]))
    rank = jnp.sum(before, axis=1)          # rank[i] = position of element i
    return jnp.zeros((L,), jnp.int32).at[rank].set(idx.astype(jnp.int32))


def _jacobi_sweeps(a, v, max_sweeps: int, off_tol: float = 0.0):
    """Run Jacobi sweeps until the off-diagonal norm reaches
    ``max(eps, off_tol) * ||A||`` in the working dtype (or max_sweeps).
    ``v`` accumulates rotations on the right; both carry the tournament
    layout, which is a permutation of the identity and gets undone by the
    caller's final sort.  ``off_tol``: relative off-norm target; solvers
    that only need the reduced eigensolve a few orders below their own
    residual tolerance pass e.g. 1e-13 to save the last polish sweep.

    Brent-Luk parallel ordering: in each round, physical row i is paired
    with physical row i + L/2 (all L/2 rotations are disjoint and applied
    at once via static half-matrix slices), and the tournament then
    *rotates the data layout* — top half becomes [t0, b0, t1..t_{L/2-2}],
    bottom half [b1..b_{L/2-1}, t_{L/2-1}].  The permutation is fused into
    the rotation's concatenation, so each round materializes each matrix
    exactly once per axis with no dynamic gathers/scatters — a tiny, fast
    compiled program regardless of dimension.
    """
    L = a.shape[-1]
    L2 = L // 2
    dtype = a.dtype
    eps = jnp.finfo(dtype).eps
    anorm = jnp.linalg.norm(a)
    # off_tol may be a TRACED scalar: solvers adapt it per iteration to
    # their current residual level (loose early, machine-eps at the end)
    rel = jnp.maximum(jnp.asarray(off_tol, dtype), eps)
    tol = rel * jnp.maximum(anorm, jnp.asarray(1.0, dtype))
    eye = jnp.eye(L, dtype=bool)

    def offnorm(m):
        # sum directly over off-diagonal entries: the tempting
        # ||m||^2 - ||diag||^2 cancels catastrophically near convergence
        # and stalls the sweep loop around sqrt(eps)*||A||
        off = jnp.where(eye, 0.0, m)
        return jnp.linalg.norm(off)

    def rotate_permute(x, c, s, axis):
        """Pair-rotate (i, i+L2) along ``axis`` and apply the tournament
        permutation, fused into one 5-slice concatenation."""
        p = jax.lax.slice_in_dim(x, 0, L2, axis=axis)
        q = jax.lax.slice_in_dim(x, L2, L, axis=axis)
        if axis == 0:
            cb, sb = c[:, None], s[:, None]
        else:
            cb, sb = c[None, :], s[None, :]
        top = cb * p - sb * q
        bot = sb * p + cb * q
        sl = jax.lax.slice_in_dim
        if L2 == 1:  # single pair: the tournament is trivial (L=2 inputs
            # reach here via 1x1/2x2 reduced problems and SVDs)
            return jnp.concatenate([top, bot], axis=axis)
        return jnp.concatenate(
            [sl(top, 0, 1, axis=axis), sl(bot, 0, 1, axis=axis),
             sl(top, 1, L2 - 1, axis=axis),
             sl(bot, 1, L2, axis=axis), sl(top, L2 - 1, L2, axis=axis)],
            axis=axis)

    def round_step(i, carry):
        m, v = carry
        d = jnp.diagonal(m)
        app = d[:L2]
        aqq = d[L2:]
        apq = jnp.diagonal(m[:L2, L2:])  # m[i, i + L2]
        small = jnp.abs(apq) <= eps * anorm * 1e-3
        tau = (aqq - app) / jnp.where(small, 1.0, 2.0 * apq)
        sgn = jnp.where(tau >= 0.0, 1.0, -1.0)  # sign(0) must be +1 here
        t = sgn / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
        t = jnp.where(small, 0.0, t)
        c = 1.0 / jnp.sqrt(1.0 + t * t)
        s = t * c
        m = rotate_permute(m, c, s, 0)
        m = rotate_permute(m, c, s, 1)
        v = rotate_permute(v, c, s, 1)
        return (m, v)

    qthresh = jnp.sqrt(eps) * jnp.maximum(anorm, jnp.asarray(1.0, dtype))

    def sweep_cond(carry):
        m, _, it, prev_off = carry
        off = offnorm(m)
        # the eps*||A|| target is unattainable for L beyond ~100 (the
        # off-norm floor scales with L), so ALSO stop when a full sweep no
        # longer makes progress — without this every large solve burned all
        # max_sweeps at the floor (measured 3x the converged cost at L=630).
        # The plateau exit only applies in the quadratic regime
        # (off < sqrt(eps)*||A||): early sweeps on clustered spectra can
        # legitimately progress by <10% and must not be cut short.
        plateau = (off < qthresh) & (off >= 0.9 * prev_off)
        return (off > tol) & (~plateau) & (it < max_sweeps)

    def sweep_body(carry):
        m, v, it, _ = carry
        off_before = offnorm(m)
        m, v = jax.lax.fori_loop(0, L - 1, round_step, (m, v))
        return (m, v, it + 1, off_before)

    m, v, _, _ = jax.lax.while_loop(
        sweep_cond, sweep_body,
        (a, v, jnp.asarray(0, jnp.int32), jnp.asarray(jnp.inf, dtype)),
    )
    return m, v


def jacobi_eigh(a, max_sweeps: int = 30, mixed_precision: bool = True,
                v0=None, off_tol: float = 0.0):
    """Eigendecomposition of a symmetric matrix by cyclic Jacobi.

    Returns (w, v) with w ascending and columns of v the eigenvectors,
    matching jnp.linalg.eigh (quadratic convergence, ~8-10 sweeps).

    For float64 input with ``mixed_precision`` (default), the bulk of the
    sweeps runs in float32 and the result seeds a float64 phase: A1 = V32^T A V32 is
    nearly diagonal, so only ~2 double-precision sweeps remain.  The final
    accuracy is set entirely by the float64 phase.

    ``v0``: optional orthonormal warm-start basis (e.g. the eigenvectors
    of a nearby matrix).  Only the single-phase path uses it: the
    appended-block structure of growing solver matrices keeps the rotated
    off-norm at ~0.4, so in the mixed path a pre-rotation barely cuts the
    f32 sweep count while adding compose/rotate matmuls, and the mixed
    path ignores v0.  ``off_tol``: relative off-diagonal target, may be a
    traced scalar (see _jacobi_sweeps); 0 keeps machine-precision
    polishing.
    """
    L0 = a.shape[-1]
    dtype = a.dtype
    L = L0 + (L0 % 2)  # pad odd dimensions with a decoupled unit row/col
    if L != L0:
        a = jnp.pad(a, ((0, 1), (0, 1)))
        if v0 is not None:
            v0 = jnp.pad(v0, ((0, 1), (0, 1)))
            v0 = v0.at[L0, L0].set(1.0)

    if mixed_precision and dtype == jnp.float64:
        # v0 deliberately unused here — see the docstring measurement
        a32 = a.astype(jnp.float32)
        m32, v32 = _jacobi_sweeps(a32, jnp.eye(L, dtype=jnp.float32),
                                  max_sweeps)
        vv = v32.astype(jnp.float64)
        # re-orthonormalize the f32-accurate basis (two Newton steps of the
        # polar iteration, error eps32 -> eps32^4) so the f64 phase starts
        # from an orthogonal V
        for _ in range(2):
            vv = 1.5 * vv - 0.5 * mm(vv, mTm(vv, vv))
        a1 = mTm(vv, mm(a, vv))
        m, v = _jacobi_sweeps(0.5 * (a1 + a1.T), vv, max_sweeps,
                              off_tol=off_tol)
    else:
        if v0 is not None:
            a1 = mTm(v0, mm(a, v0))
            m, v = _jacobi_sweeps(0.5 * (a1 + a1.T), v0, max_sweeps,
                                  off_tol=off_tol)
        else:
            m, v = _jacobi_sweeps(a, jnp.eye(L, dtype=dtype), max_sweeps,
                                  off_tol=off_tol)

    w = jnp.diagonal(m)
    order = rank_argsort(w)
    w = w[order]
    v = v[:, order]
    if L != L0:
        # drop the pad eigenpair (eigenvalue 0, vector e_{L0}) wherever the
        # sort placed it; identify it by its support on the pad row
        pad_col = jnp.argmax(jnp.abs(v[L0, :]))
        idx = jnp.arange(L)
        non_pad = idx != pad_col
        pos = jnp.sum(non_pad[None, :] & (idx[None, :] < idx[:, None]), axis=1)
        keep = jnp.zeros((L0,), jnp.int32).at[
            jnp.where(non_pad, pos, L0)
        ].set(idx.astype(jnp.int32), mode="drop")
        w = w[keep]
        v = v[:L0, keep]
    return w, v


def jacobi_svd(a, max_sweeps: int = 30, off_tol: float = 0.0):
    """SVD of a square matrix via Jacobi on [[0, A^T], [A, 0]].

    Returns (u, s, vt) with s descending, matching jnp.linalg.svd for
    square inputs.  The augmented symmetric matrix has eigenpairs
    (+/- sigma_i, (v_i; +/- u_i)/sqrt(2)).  ``off_tol`` as in jacobi_eigh
    (may be traced).
    """
    L = a.shape[-1]
    dtype = a.dtype
    zero = jnp.zeros_like(a)
    aug = jnp.block([[zero, a.T], [a, zero]])
    w, x = jacobi_eigh(aug, max_sweeps, off_tol=off_tol)
    # positive half, descending
    s = w[::-1][:L]
    xs = x[:, ::-1][:, :L]
    sqrt2 = jnp.sqrt(jnp.asarray(2.0, dtype))
    v = xs[:L, :] * sqrt2
    u = xs[L:, :] * sqrt2
    # renormalize defensively (zero singular values leave arbitrary scale)
    def unit(m):
        nrm = jnp.linalg.norm(m, axis=0, keepdims=True)
        return m / jnp.where(nrm == 0.0, 1.0, nrm)

    return unit(u), s, unit(v).T


def _onesided_sweeps(a, v, max_sweeps: int, off_tol=0.0):
    """One-sided (Hestenes) Jacobi column-orthogonalization rounds.

    Rotates COLUMN pairs of ``a`` (accumulating the same rotations into
    ``v``) until every pair satisfies |a_p . a_q| <= rel * ||a_p|| ||a_q||
    with rel = max(eps, off_tol), using the same Brent-Luk tournament /
    fused permutation as _jacobi_sweeps.  On exit a = (input a) @ V with
    nearly orthogonal columns: column norms are the singular values.
    """
    L = a.shape[-1]
    L2 = L // 2
    dtype = a.dtype
    eps = jnp.finfo(dtype).eps
    rel = jnp.maximum(jnp.asarray(off_tol, dtype), eps)
    tiny = jnp.asarray(jnp.finfo(dtype).tiny, dtype)

    def rotate_permute(x, c, s):
        p = jax.lax.slice_in_dim(x, 0, L2, axis=1)
        q = jax.lax.slice_in_dim(x, L2, L, axis=1)
        cb, sb = c[None, :], s[None, :]
        top = cb * p - sb * q
        bot = sb * p + cb * q
        sl = jax.lax.slice_in_dim
        if L2 == 1:
            return jnp.concatenate([top, bot], axis=1)
        return jnp.concatenate(
            [sl(top, 0, 1, axis=1), sl(bot, 0, 1, axis=1),
             sl(top, 1, L2 - 1, axis=1),
             sl(bot, 1, L2, axis=1), sl(top, L2 - 1, L2, axis=1)],
            axis=1)

    def round_step(i, carry):
        m, v, mx = carry
        p = m[:, :L2]
        q = m[:, L2:]
        app = jnp.sum(p * p, axis=0)
        aqq = jnp.sum(q * q, axis=0)
        apq = jnp.sum(p * q, axis=0)
        denom = jnp.sqrt(app * aqq) + tiny
        rel_pq = jnp.abs(apq) / denom
        mx = jnp.maximum(mx, jnp.max(rel_pq))
        small = rel_pq <= eps * 1e-2
        tau = (aqq - app) / jnp.where(small, 1.0, 2.0 * apq)
        sgn = jnp.where(tau >= 0.0, 1.0, -1.0)
        t = sgn / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
        t = jnp.where(small, 0.0, t)
        c = 1.0 / jnp.sqrt(1.0 + t * t)
        s = t * c
        return (rotate_permute(m, c, s), rotate_permute(v, c, s), mx)

    def sweep_cond(carry):
        _, _, it, mx, prev = carry
        # plateau exit (like _jacobi_sweeps): near the rounding floor a
        # full sweep stops improving the worst pair angle — without this
        # a floor slightly above rel burns the whole sweep budget
        plateau = (mx < jnp.sqrt(eps)) & (mx >= 0.9 * prev)
        return (mx > rel) & (~plateau) & (it < max_sweeps)

    def sweep_body(carry):
        m, v, it, mx, _ = carry
        m, v, mx_new = jax.lax.fori_loop(
            0, L - 1, round_step,
            (m, v, jnp.asarray(0.0, dtype)))
        return (m, v, it + 1, mx_new, mx)

    m, v, _, _, _ = jax.lax.while_loop(
        sweep_cond, sweep_body,
        (a, v, jnp.asarray(0, jnp.int32), jnp.asarray(jnp.inf, dtype),
         jnp.asarray(jnp.inf, dtype)))
    return m, v


def jacobi_svd_onesided(a, max_sweeps: int = 30, off_tol: float = 0.0,
                        mixed_precision: bool = True):
    """SVD of a square matrix by ONE-SIDED (Hestenes) Jacobi.

    Same contract as :func:`jacobi_svd` (u, s descending, vt for square
    inputs) at roughly 1/4-1/8 of its cost: the augmented two-sided form
    diagonalizes a 2L x 2L matrix (8x the rotation work per sweep), while
    the one-sided form rotates the L columns of A directly — and σ comes
    from column NORMS, so small singular values keep full relative
    accuracy (no Gram squaring).  Requires nonsingular-ish A for the U
    columns (zero columns get a defensive renormalization like
    jacobi_svd).  ``off_tol`` is the relative pair-orthogonality target
    (traceable); for float64 input with ``mixed_precision`` the bulk of
    the sweeps runs in f32 and a polar-corrected V warm-starts the f64
    finish.
    """
    L0 = a.shape[-1]
    dtype = a.dtype
    L = L0 + (L0 % 2)
    if L != L0:
        # pad with a decoupled unit column/row: keeps the matrix square
        # and nonsingular; the pad singular value is exactly 1
        a = jnp.pad(a, ((0, 1), (0, 1)))
        a = a.at[L0, L0].set(1.0)

    if mixed_precision and dtype == jnp.float64:
        m32, v32 = _onesided_sweeps(a.astype(jnp.float32),
                                    jnp.eye(L, dtype=jnp.float32),
                                    max_sweeps)
        vv = v32.astype(jnp.float64)
        for _ in range(2):
            vv = 1.5 * vv - 0.5 * mm(vv, mTm(vv, vv))
        m, v = _onesided_sweeps(mm(a, vv), vv, max_sweeps, off_tol=off_tol)
    else:
        m, v = _onesided_sweeps(a, jnp.eye(L, dtype=dtype), max_sweeps,
                                off_tol=off_tol)

    s = jnp.sqrt(jnp.sum(m * m, axis=0))
    order = rank_argsort(s, descending=True)
    s = s[order]
    u = m[:, order] / jnp.where(s == 0.0, 1.0, s)[None, :]
    v = v[:, order]
    if L != L0:
        # drop the pad triplet (σ = 1, u/v = e_{L0}) wherever the sort
        # placed it, identified by support on the pad row of v
        pad_col = jnp.argmax(jnp.abs(v[L0, :]))
        idx = jnp.arange(L)
        non_pad = idx != pad_col
        pos = jnp.sum(non_pad[None, :] & (idx[None, :] < idx[:, None]),
                      axis=1)
        keep = jnp.zeros((L0,), jnp.int32).at[
            jnp.where(non_pad, pos, L0)
        ].set(idx.astype(jnp.int32), mode="drop")
        s = s[keep]
        u = u[:L0, keep]
        v = v[:L0, keep]
    return u, s, v.T
