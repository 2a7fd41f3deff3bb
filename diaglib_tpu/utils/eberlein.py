"""On-device eigensolver for small real NONSYMMETRIC matrices.

The nonsym driver (solvers/nonsym.py, re-designing diaglib.f90:2252-2943)
needs the eigendecomposition of its small reduced Gram matrix every
iteration.  Without this module that needs a host LAPACK ``dgeev`` (a
callback, or a Python-orchestrated loop on runtimes without callbacks).
This module keeps it on device: a norm-reducing Jacobi-like method
(Eberlein, SIAM J. 10, 1962; parallel orderings per Brent-Luk) that runs
entirely on device inside ``jit``/``lax.while_loop``.

Each Brent-Luk round applies, to every disjoint pivot pair (p, q):

1. an orthogonal ROTATION chosen to annihilate the SYMMETRIC part of the
   2x2 pivot block (classical Jacobi on (A + A^T)/2) — for a symmetric
   input the method degenerates to plain Jacobi; and
2. a norm-reducing SHEAR, the similarity T^-1 A T with
   T = [[cosh y, sinh y], [sinh y, cosh y]] on the (p, q) plane.  With
   d = a_pp - a_qq, v = a_pq - a_qp,
   P = sum_{i != p,q} (a_ip^2 + a_iq^2 + a_pi^2 + a_qi^2),
   Q = 2 sum_{i != p,q} (a_ip a_iq - a_pi a_qi),
   the Frobenius norm of the transformed matrix is
   f(y) = const + P cosh 2y + Q sinh 2y
        + (d^2 + v^2)/2 cosh 4y + d v sinh 4y,
   which is CONVEX in y (|Q| <= P and 2|dv| <= d^2 + v^2 by
   Cauchy-Schwarz), so the damped Newton step from 0,
   y = -(Q + 2 d v) / (2 P + 4 (d^2 + v^2)),
   strictly reduces ||A'||_F toward the normality bound
   ||A||_F^2 >= sum |lambda_i|^2.

Rotations drive a NORMAL matrix with real spectrum to diagonal form;
shears drive the departure from normality to zero — together the
iteration converges to diagonal for diagonalizable real-spectrum
matrices (the nonsym driver's target contract) and to 2x2 skew-coupled
blocks for complex-conjugate pairs, whose imaginary magnitudes are read
off the block discriminants (transient complex pairs get PARKED by the
caller, never extracted).  Defective matrices are outside the contract:
the normality infimum is then unattainable and the sweep cap stops the
iteration (same failure surface as the reference's dgeev-based homing on
a stalled spectrum).

Accumulating S (right factor) and S^-1 (left factor, maintained exactly
by applying each elementary inverse) yields BOTH eigenvector sides from
one iteration: A S = S diag(w), S^-1 A = diag(w) S^-1 — i.e. columns of S
are the right eigenvectors and columns of S^-T the left ones, the pair
the two-sided Davidson needs (diaglib.f90:2499 dgeev with both jobvl and
jobvr).

Mixed precision mirrors utils/jacobi.py: the bulk of the sweeps runs in
float32, then S^-1 is Newton-refined in f64
(X <- X (2I - S X), quadratic) so A1 = S^-1 A S is an exact-to-f64
similarity seeding ~2 double-precision sweeps.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .mm import mm
from .jacobi import rank_argsort

__all__ = ["eberlein_eig"]


def _pair_apply(x, alpha, beta, gamma, delta, axis, permute):
    """Apply [[alpha, beta], [gamma, delta]] to every Brent-Luk pair
    (i, i + L/2) along ``axis``: top' = alpha*top + beta*bot,
    bot' = gamma*top + delta*bot; optionally fuse the tournament
    permutation into the output concatenation (utils/jacobi.py
    rotate_permute generalized to four independent coefficients, as the
    shear's row and column transforms differ)."""
    L = x.shape[axis]
    L2 = L // 2
    sl = jax.lax.slice_in_dim
    p = sl(x, 0, L2, axis=axis)
    q = sl(x, L2, L, axis=axis)
    if axis == 0:
        bc = lambda v: v[:, None]  # noqa: E731
    else:
        bc = lambda v: v[None, :]  # noqa: E731
    top = bc(alpha) * p + bc(beta) * q
    bot = bc(gamma) * p + bc(delta) * q
    if not permute or L2 == 1:
        return jnp.concatenate([top, bot], axis=axis)
    return jnp.concatenate(
        [sl(top, 0, 1, axis=axis), sl(bot, 0, 1, axis=axis),
         sl(top, 1, L2 - 1, axis=axis),
         sl(bot, 1, L2, axis=axis), sl(top, L2 - 1, L2, axis=axis)],
        axis=axis)


def _block_entries(m, L2):
    d = jnp.diagonal(m)
    app, aqq = d[:L2], d[L2:]
    apq = jnp.diagonal(m[:L2, L2:])
    aqp = jnp.diagonal(m[L2:, :L2])
    return app, aqq, apq, aqp


def _eberlein_sweeps(a, s, sinv, max_sweeps: int, off_tol=0.0):
    """Rotation+shear sweeps; returns (m, s, sinv) in tournament layout.

    ``off_tol``: relative effective-off-norm target with an eps floor
    (traceable) — same adaptive-relaxation contract as
    utils/jacobi._jacobi_sweeps."""
    L = a.shape[-1]
    L2 = L // 2
    dtype = a.dtype
    eps = jnp.finfo(dtype).eps
    anorm = jnp.linalg.norm(a)
    rel = jnp.maximum(jnp.asarray(off_tol, dtype), eps)
    tol = rel * jnp.maximum(anorm, jnp.asarray(1.0, dtype))
    eye = jnp.eye(L, dtype=bool)

    def off_eff(m):
        # EFFECTIVE off-diagonal norm: the distance from an extractable
        # converged form.  A plain off-norm is wrong twice over — the
        # symmetric part alone misses live skew couplings between real
        # eigenvalues (e.g. [[1, k], [-k, 2]] has O(k^2) eigenvalue error
        # that only shears remove), while the full off-norm is pinned at
        # |Im lambda| by converged complex pairs, hiding all remaining
        # progress behind a constant floor.  So: entries whose 2x2
        # discriminant is negative (complex-pair candidates) count only
        # their deviation from a perfect normal block ([[a, b], [-b, a]]:
        # the symmetric residual (m_ij + m_ji)/2 and the diagonal gap
        # d_ij/2, both of which the shears drive to zero), every other
        # entry counts fully.  For real spectra off_eff equals the full
        # off-norm asymptotically; for complex pairs it still -> 0.
        d = jnp.diagonal(m)
        half = 0.5 * (d[:, None] - d[None, :])
        disc = half * half + m * m.T
        sym = 0.5 * (m + m.T)
        contrib = jnp.where(disc < 0.0, sym * sym + half * half, m * m)
        return jnp.sqrt(jnp.sum(jnp.where(eye, 0.0, contrib)))

    def round_step(i, carry):
        m, s, sinv = carry
        # --- rotation: classical Jacobi on the symmetric part ---
        app, aqq, apq, aqp = _block_entries(m, L2)
        u = apq + aqp                      # 2 * sym(A)_pq
        small = jnp.abs(u) <= eps * anorm * 1e-3
        tau = (aqq - app) / jnp.where(small, 1.0, u)
        sgn = jnp.where(tau >= 0.0, 1.0, -1.0)
        t = sgn / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
        t = jnp.where(small, 0.0, t)
        c = 1.0 / jnp.sqrt(1.0 + t * t)
        sr = t * c
        m = _pair_apply(m, c, -sr, sr, c, 0, permute=False)
        m = _pair_apply(m, c, -sr, sr, c, 1, permute=False)
        s = _pair_apply(s, c, -sr, sr, c, 1, permute=False)
        sinv = _pair_apply(sinv, c, -sr, sr, c, 0, permute=False)

        # --- shear: damped Newton on the convex norm function f(y) ---
        app, aqq, apq, aqp = _block_entries(m, L2)
        blk_sq = app * app + aqq * aqq + apq * apq + aqp * aqp
        colsq = jnp.sum(m * m, axis=0)
        rowsq = jnp.sum(m * m, axis=1)
        colprod = jnp.sum(m[:, :L2] * m[:, L2:], axis=0)
        rowprod = jnp.sum(m[:L2, :] * m[L2:, :], axis=1)
        P = (colsq[:L2] + colsq[L2:] + rowsq[:L2] + rowsq[L2:]
             - 2.0 * blk_sq)
        Q = 2.0 * ((colprod - app * apq - aqp * aqq)
                   - (rowprod - app * aqp - apq * aqq))
        dd = app - aqq
        vv = apq - aqp
        denom = 2.0 * P + 4.0 * (dd * dd + vv * vv)
        tiny = eps * anorm * anorm * 1e-3
        y = -(Q + 2.0 * dd * vv) / jnp.where(denom <= tiny, 1.0, denom)
        y = jnp.where(denom <= tiny, 0.0, y)
        # convexity makes any step between 0 and the minimizer a strict
        # descent; the clamp guards the far-from-normal regime where the
        # Newton step could overshoot past the symmetric minimizer pair
        y = jnp.clip(y, -0.25, 0.25)
        ch = jnp.cosh(y)
        sh = jnp.sinh(y)
        m = _pair_apply(m, ch, -sh, -sh, ch, 0, permute=True)
        m = _pair_apply(m, ch, sh, sh, ch, 1, permute=True)
        s = _pair_apply(s, ch, sh, sh, ch, 1, permute=True)
        sinv = _pair_apply(sinv, ch, -sh, -sh, ch, 0, permute=True)
        return (m, s, sinv)

    qthresh = jnp.sqrt(eps) * jnp.maximum(anorm, jnp.asarray(1.0, dtype))

    def sweep_cond(carry):
        m, _, _, it, prev_off = carry
        off = off_eff(m)
        # plateau exits as in utils/jacobi.py: the eps*||A|| target is
        # unattainable at large L (quadratic regime), and a hard stall
        # anywhere (e.g. a defective matrix pinning the normality gap)
        # must not burn the sweep budget
        plateau = (off < qthresh) & (off >= 0.9 * prev_off)
        stall = off >= 0.999 * prev_off
        return (off > tol) & (~plateau) & (~stall) & (it < max_sweeps)

    def sweep_body(carry):
        m, s, sinv, it, _ = carry
        off_before = off_eff(m)
        m, s, sinv = jax.lax.fori_loop(0, L - 1, round_step, (m, s, sinv))
        return (m, s, sinv, it + 1, off_before)

    m, s, sinv, _, _ = jax.lax.while_loop(
        sweep_cond, sweep_body,
        (a, s, sinv, jnp.asarray(0, jnp.int32),
         jnp.asarray(jnp.inf, dtype)),
    )
    return m, s, sinv


def _wi_estimate(m, wr):
    """|Im lambda| per index from the 2x2 block discriminants of the
    converged matrix: disc_ij = ((wr_i - wr_j)/2)^2 + m_ij m_ji; a
    complex-conjugate pair converges to a skew coupling with
    disc = -Im^2 < 0, every real-spectrum coupling decays to ~0."""
    half = 0.5 * (wr[:, None] - wr[None, :])
    disc = half * half + m * m.T
    neg = jnp.sqrt(jnp.maximum(-disc, 0.0))
    neg = jnp.where(jnp.eye(m.shape[0], dtype=bool), 0.0, neg)
    return jnp.max(neg, axis=1)


def _unit_cols(v):
    nrm = jnp.linalg.norm(v, axis=0, keepdims=True)
    return v / jnp.where(nrm == 0.0, 1.0, nrm)


def eberlein_eig(a, max_sweeps: int = 30, mixed_precision: bool = True,
                 off_tol=0.0):
    """Eigendecomposition of a small real nonsymmetric matrix on device.

    Returns ``(wr, wi, vr, vl)`` with wr ascending, |Im| magnitudes in
    ``wi`` (signs are not resolved — the callers only park on |wi|,
    diaglib.f90:2377 tol_im), unit right eigenvectors in the columns of
    ``vr`` and unit left eigenvectors in the columns of ``vl``
    (vl^T A = wr vl^T), matching what the nonsym driver consumes from
    LAPACK dgeev.  Contract: diagonalizable with (mostly) real spectrum;
    complex pairs are located and measured but their vector columns are
    only the real 2x2-block basis, and defective inputs stall at the
    sweep cap (see module docstring).
    """
    L0 = a.shape[-1]
    dtype = a.dtype
    L = L0 + (L0 % 2)
    if L != L0:
        a = jnp.pad(a, ((0, 1), (0, 1)))

    if mixed_precision:
        # bulk sweeps in f32, finish in f64 — for f32 inputs too: the f32
        # accumulation drift (~sqrt(rounds)*eps32*||A||, measured ~1% of
        # the spectrum spread at L~300) is far too coarse to return raw,
        # and the host-dgeev path this replaces always solves in f64
        a64 = a.astype(jnp.float64)
        a32 = a.astype(jnp.float32)
        eye32 = jnp.eye(L, dtype=jnp.float32)
        _, s32, sinv32 = _eberlein_sweeps(a32, eye32, eye32, max_sweeps)
        s0 = s32.astype(jnp.float64)
        sinv0 = sinv32.astype(jnp.float64)
        # Newton-refine the inverse so the f64 phase starts from an exact
        # similarity pair.  The two f32 accumulators drift APART by
        # ||Sinv S - I|| ~ 0.2 at L~300 (random-walk rounding), so four
        # quadratic steps (0.2 -> 4e-2 -> 2e-3 -> 3e-6 -> 1e-11 and each
        # structurally better in practice) are needed, not two.
        eye2 = 2.0 * jnp.eye(L, dtype=jnp.float64)
        for _ in range(4):
            sinv0 = mm(sinv0, eye2 - mm(s0, sinv0))
        a1 = mm(sinv0, mm(a64, s0))
        m, s, sinv = _eberlein_sweeps(a1, s0, sinv0, max_sweeps,
                                      off_tol=off_tol)
        m = m.astype(dtype)
        s = s.astype(dtype)
        sinv = sinv.astype(dtype)
    else:
        eye = jnp.eye(L, dtype=dtype)
        m, s, sinv = _eberlein_sweeps(a, eye, eye, max_sweeps,
                                      off_tol=off_tol)

    wr = jnp.diagonal(m)
    wi = _wi_estimate(m, wr)
    order = rank_argsort(wr)
    wr = wr[order]
    wi = wi[order]
    vr = _unit_cols(s[:, order])
    vl = _unit_cols(sinv.T[:, order])
    if L != L0:
        # the pad row/col is exactly decoupled (zero couplings -> identity
        # transforms), so its eigenpair is (0, e_{L0}); drop it wherever
        # the sort placed it, as in utils/jacobi.py
        pad_col = jnp.argmax(jnp.abs(vr[L0, :]))
        idx = jnp.arange(L)
        non_pad = idx != pad_col
        pos = jnp.sum(non_pad[None, :] & (idx[None, :] < idx[:, None]),
                      axis=1)
        keep = jnp.zeros((L0,), jnp.int32).at[
            jnp.where(non_pad, pos, L0)
        ].set(idx.astype(jnp.int32), mode="drop")
        wr = wr[keep]
        wi = wi[keep]
        vr = vr[:L0, keep]
        vl = vl[:L0, keep]
    return wr, wi, vr, vl
