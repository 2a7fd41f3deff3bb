"""Masked static-shape linear algebra helpers.

The Fortran reference grows/shrinks its subspaces with dynamic column
arithmetic (e.g. diaglib.f90:1680-1691).  XLA requires static shapes, so
this design keeps every subspace at a fixed padded capacity and carries a
boolean validity mask (or a scalar count for prefix-valid regions).  These
helpers implement the core masked primitives used by every solver:

* ``masked_eigh``    — eigh of a masked symmetric matrix; invalid rows/cols are
  replaced by a diagonal pad larger than any genuine eigenvalue (a Gershgorin
  bound), so the genuine eigenpairs occupy the *leading* positions of the
  ascending spectrum and their eigenvectors are exactly zero on invalid rows.
* ``masked_svd``     — SVD of a masked square matrix with identity padding,
  re-sorted so genuine singular triplets occupy the leading positions in
  descending order (exactly what an SVD of the compacted matrix would give).
* ``masked_cholesky``— Cholesky with identity padding on invalid rows/cols.
* ``gather_rows``    — extract ``width`` rows starting at a dynamic offset,
  zeroing rows past a validity count (used to compact active residuals,
  cf. diaglib.f90:1786 ``r(1,ind)``).
* ``prefix_lock``    — the contiguous-prefix locking rule
  (diaglib.f90:446-455).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "prefix_mask",
    "gather_rows",
    "scatter_rows",
    "masked_eigh",
    "masked_svd",
    "masked_cholesky",
    "prefix_lock",
]


def prefix_mask(k: int, count, dtype=bool):
    """(k,) mask, True for indices < count (count may be traced)."""
    return (jnp.arange(k) < count).astype(dtype)


def gather_rows(x, start, width: int, count=None):
    """Rows ``[start, start+width)`` of x, rows >= count (relative) zeroed.

    ``start`` may be traced; ``width`` is static.  Out-of-range gathers are
    clipped and then zeroed by the count mask, so callers must pass
    ``count <= rows_available``.
    """
    idx = jnp.clip(start + jnp.arange(width), 0, x.shape[0] - 1)
    out = jnp.take(x, idx, axis=0)
    if count is not None:
        mask = jnp.arange(width) < count
        out = jnp.where(mask[(...,) + (None,) * (x.ndim - 1)], out, 0)
    return out


def scatter_rows(x, block, start):
    """Write ``block`` into x at dynamic row offset ``start`` (static width)."""
    start = jnp.asarray(start, jnp.int32)
    zeros = (jnp.asarray(0, jnp.int32),) * (x.ndim - 1)
    return jax.lax.dynamic_update_slice(x, block.astype(x.dtype), (start,) + zeros)


def _pad_value(a, outer):
    """Gershgorin-style strict upper bound on |eigenvalues| of the masked part."""
    row_sums = jnp.sum(jnp.abs(jnp.where(outer, a, 0.0)), axis=1)
    return jnp.max(row_sums) + 1.0


def masked_eigh(a, mask, method: str = "device", v0=None,
                off_tol: float = 0.0):
    """eigh of the masked symmetric matrix.

    Returns (w, v) with the genuine eigenpairs ascending in the leading
    ``count(mask)`` positions; eigenvector columns for genuine eigenvalues are
    exactly zero on masked rows (the padded matrix is block diagonal).
    ``method`` routes the dense solve (utils.reduced): "device" | "host" |
    "auto".  ``v0``/``off_tol``: warm start + relaxed target for the
    Jacobi route (reduced.eigh).
    """
    from . import reduced

    outer = mask[:, None] & mask[None, :]
    a_m = jnp.where(outer, a, 0.0)
    pad = _pad_value(a, outer)
    a_m = a_m + jnp.diag(jnp.where(mask, 0.0, pad))
    return reduced.eigh(a_m, method, v0=v0, off_tol=off_tol)


def prefix_buckets(full: int, lo: int, fine: bool = False):
    """Static solve sizes {lo, 2lo, 4lo, ...} clipped to ``full``.

    Reduced problems grow by one block per iteration, so most solves only
    need the small leading corner; bucketing the solve size caps the wasted
    cubic work at 8x while keeping everything static-shaped (SURVEY.md §7
    hard-parts: "bucket by active-count powers").

    ``fine``: switch to LINEAR steps of ``lo`` past 2*lo (lo, 2lo, 3lo,
    ...) — the cubic cost makes the doubling jump expensive at the top
    (L=120 -> 165 is 2.6x the flops), so drivers whose reduced solve dominates the
    iteration (davidson) trade a few more compiled branches (each a tiny
    dimension-independent Jacobi program) for tighter sizes; drivers whose
    COMPILE budget dominates (the nonsym Eberlein buckets) stay coarse."""
    sizes = []
    s = max(1, int(lo))
    while s < full:
        sizes.append(s)
        s = s + lo if (fine and s >= 2 * lo) else s * 2
    sizes.append(full)
    return tuple(sizes)


def bucketed_switch(make, ldu, full: int, lo: int, fine: bool = False):
    """Dispatch to ``make(L)()`` for the smallest bucket L >= ldu.

    ``make(L)`` returns a thunk computing the solve restricted to the
    leading L x L prefix, padded back to full-width output shapes (all
    branches of the ``lax.switch`` must agree).  Exact whenever the
    genuine data occupies the leading ldu rows/cols (prefix masks).
    """
    sizes = prefix_buckets(full, lo, fine)
    if len(sizes) == 1:
        return make(full)(None)
    idx = jnp.sum(
        ldu > jnp.asarray(sizes[:-1], jnp.int32)).astype(jnp.int32)
    return jax.lax.switch(idx, [make(L) for L in sizes], None)


def masked_eigh_bucketed(a, mask, ldu, lo: int, method: str = "device",
                         v0=None, off_tol: float = 0.0, fine: bool = False):
    """masked_eigh on the smallest prefix bucket covering ``ldu``.

    ``mask`` must be a PREFIX mask with population ``ldu`` (the solvers'
    ``col_ok``): the genuine block lives in the leading ldu x ldu corner,
    so solving the leading L x L bucket (L >= ldu) is exact at L^3 cost
    instead of full^3.  Positions beyond the bucket get the same
    above-spectrum pad eigenvalues as masked diagonal entries (the pad is
    computed from the full genuine region, so the two pad families agree)
    and zero eigenvector columns.

    ``v0``: optional full-width warm-start matrix — typically the previous
    iteration's ``v`` output of this same function (zero outside its own
    bucket).  All-zero columns inside the current bucket are replaced by
    identity columns, which keeps the slice orthonormal when the bucket
    grew or the previous call solved a smaller prefix.
    """
    full = a.shape[0]
    outer = mask[:, None] & mask[None, :]
    pad = _pad_value(a, outer)

    def make(L):
        def run(_):
            w0 = None
            if v0 is not None:
                v0L = v0[:L, :L]
                fill = jnp.sum(v0L * v0L, axis=0) == 0.0
                w0 = v0L + jnp.diag(fill.astype(a.dtype))
            w, v = masked_eigh(a[:L, :L], mask[:L], method, v0=w0,
                               off_tol=off_tol)
            w_out = jnp.concatenate(
                [w, jnp.full((full - L,), 1.0, a.dtype) * pad])
            v_out = jnp.zeros((full, full), a.dtype).at[:L, :L].set(v)
            return w_out, v_out
        return run

    return bucketed_switch(make, ldu, full, lo, fine)


def masked_svd(a, mask, method: str = "device", off_tol: float = 0.0):
    """SVD of the masked square matrix, genuine triplets leading.

    Masked rows/cols are padded with a diagonal strictly ABOVE the genuine
    spectrum (a Frobenius bound + 2): a pad value inside the genuine range
    (e.g. 1.0, where the singular values of near-orthonormal overlap
    matrices cluster) can make the backend SVD mix degenerate pad and
    genuine subspaces.  The triplets are then re-sorted (stably) by
    genuineness — a left singular vector supported on valid rows is
    genuine — so the result equals the SVD of the compacted matrix,
    embedded at the leading positions.
    """
    from . import reduced

    outer = mask[:, None] & mask[None, :]
    a_v = jnp.where(outer, a, 0.0)
    pad = jnp.sqrt(jnp.sum(a_v * a_v)) + 2.0
    a_m = a_v + jnp.diag(jnp.where(mask, 0.0, pad))
    u, s, vt = reduced.svd(a_m, method, off_tol=off_tol)
    # score ~ 1 for genuine columns (support on valid rows), ~0 for pad columns
    from .jacobi import rank_argsort

    score = jnp.sum(jnp.where(mask[:, None], u, 0.0) ** 2, axis=0)
    order = rank_argsort(jnp.where(score > 0.5, 0.0, 1.0))
    return u[:, order], s[order], vt[order, :]


def masked_cholesky(a, mask):
    """Lower Cholesky factor of the masked SPD matrix (identity padding).

    Returns (L, failed): ``failed`` is True when the factorization produced
    non-finite entries, i.e. the matrix is not positive definite — the signal
    the reference gets from dpotrf's ``info`` (diaglib.f90:3261-3265).
    """
    outer = mask[:, None] & mask[None, :]
    a_m = jnp.where(outer, a, 0.0) + jnp.diag(jnp.where(mask, 0.0, 1.0))
    chol = jnp.linalg.cholesky(a_m)
    failed = ~jnp.all(jnp.isfinite(chol))
    return chol, failed


def prefix_lock(done, conv, n_targ: int):
    """Contiguous-prefix locking (diaglib.f90:446-455).

    A root is locked iff it and every preceding root (within the first
    ``n_targ``) satisfy the convergence test or were already locked.
    Roots beyond ``n_targ`` are never locked (the Fortran loops stop at
    n_targ and reset the tail to false).
    """
    cand = (done | conv).astype(jnp.int32)
    prefix = jnp.cumprod(cand).astype(bool)
    targ = jnp.arange(done.shape[0]) < n_targ
    return prefix & targ
