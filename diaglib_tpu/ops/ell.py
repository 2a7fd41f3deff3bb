"""ELLPACK sparse operator for scalar-granular (non-block) sparsity.

The BSR operator (ops/bsr.py) serves block-structured sparsity: its B x B
blocks become dense matmuls.  Matrices with *unstructured scalar* sparsity
(no block structure to exploit) have no matmul to offer — each nonzero
does one multiply — so the format here is ELLPACK: every row padded to a
fixed ``L`` slots, giving static shapes and a vectorized gather/FMA per
slot.  One slot = one (k, n) gather of x plus an elementwise
multiply-accumulate; the whole matvec is a ``lax.scan`` over the L slots
(L = max nonzeros/row, typically tens).

Padding slots point at column 0 with value 0.0.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["ELLMatrix", "ell_from_dense", "ell_from_coo", "ell_matvec",
           "ell_diagonal", "ell_to_dense"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ELLMatrix:
    """Row-padded sparse matrix: vals/cols are (n, L)."""

    vals: jax.Array
    cols: jax.Array
    n: int = dataclasses.field(metadata=dict(static=True))

    @property
    def slots(self) -> int:
        return self.vals.shape[1]

    @property
    def nnz(self) -> int:
        return int(jnp.sum(self.vals != 0.0))


def ell_from_coo(rows, cols, vals, n: int) -> ELLMatrix:
    """Build from COO triplets (host-side; duplicates are summed)."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    # sum duplicates (np.unique sorts by key; no presort needed)
    key = rows.astype(np.int64) * n + cols
    uniq, inv = np.unique(key, return_inverse=True)
    acc = np.zeros(len(uniq), vals.dtype)
    np.add.at(acc, inv, vals)
    rows, cols, vals = (uniq // n).astype(np.int32), (uniq % n).astype(
        np.int32), acc
    counts = np.bincount(rows, minlength=n)
    L = max(1, int(counts.max()))
    v = np.zeros((n, L), vals.dtype)
    c = np.zeros((n, L), np.int32)
    slot = np.concatenate([np.arange(k) for k in counts]) if len(rows) else []
    v[rows, slot] = vals
    c[rows, slot] = cols
    return ELLMatrix(vals=jnp.asarray(v), cols=jnp.asarray(c), n=n)


def ell_from_dense(a) -> ELLMatrix:
    a = np.asarray(a)
    r, c = np.nonzero(a)
    return ell_from_coo(r, c, a[r, c], a.shape[0])


def ell_to_dense(m: ELLMatrix):
    out = jnp.zeros((m.n, m.n), m.vals.dtype)
    rows = jnp.broadcast_to(jnp.arange(m.n)[:, None], m.cols.shape)
    return out.at[rows, m.cols].add(m.vals)


def ell_diagonal(m: ELLMatrix):
    hit = m.cols == jnp.arange(m.n)[:, None]
    return jnp.sum(jnp.where(hit, m.vals, 0.0), axis=1)


def ell_matvec(m: ELLMatrix):
    """Matvec closure ``x: (k, n) -> (k, n)``; one gather+FMA per slot."""

    def mv(x):
        def body(acc, slot):
            v, c = slot
            return acc + v[None, :] * jnp.take(x, c, axis=1), None

        init = jnp.zeros_like(x)
        out, _ = jax.lax.scan(
            body, init, (m.vals.T, m.cols.T))  # scan over L slots
        return out

    return mv
