"""Block-sparse-row (BSR) operator and its SpMM.

The reference never materializes the matrix — users supply ``matvec``
callbacks (README.md:30-44).  The benchmark's flagship workload is a large
sparse operator, so this module provides the canonical callback: a BSR
matrix whose row-block matvec is plain ``jax.numpy`` that XLA compiles for
the device: one gather of x blocks and one batched matmul per block row.

Layout: vectors are rows (k, n) like everywhere in this library; the matvec
computes ``y = x @ A^T`` (i.e. y_i = A x_i per row) as

    y[:, r*B:(r+1)*B] = sum_e in row r   x[:, col_e*B:(col_e+1)*B] @ T_e

with ``T_e = blocks[e]^T`` stored pre-transposed so the inner contraction
is a plain (k, B) @ (B, B) matmul.  Every block row holds the same number
``row_len`` of entries (rows with fewer are padded with explicit zero
blocks), so a row's sum is one (k, row_len*B) @ (row_len*B, B) product and
no scatter is needed: the result is deterministic.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "BSRMatrix",
    "bsr_astype",
    "bsr_from_dense",
    "bsr_to_dense",
    "bsr_matvec",
    "bsr_diagonal",
    "random_bsr_spd",
]

_HI = jax.lax.Precision.HIGHEST


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BSRMatrix:
    """Square block-sparse matrix with uniform B x B blocks.

    blocks_t: (nnzb, B, B) — the e-th block stored TRANSPOSED (ready for
              ``x_blk @ blocks_t[e]``).
    rows:     (nnzb,) int32 block-row index of each entry.
    cols:     (nnzb,) int32 block-col index of each entry.
    n:        matrix dimension (nbr * B).

    Entries are sorted by row and every block row holds exactly
    ``row_len = nnzb // nbr`` of them (padding entries carry zero blocks);
    the builders below guarantee this.
    """

    blocks_t: jax.Array
    rows: jax.Array
    cols: jax.Array
    n: int = dataclasses.field(metadata=dict(static=True))
    block: int = dataclasses.field(metadata=dict(static=True))

    @property
    def nnzb(self) -> int:
        return self.blocks_t.shape[0]

    @property
    def nnz(self) -> int:
        return self.nnzb * self.block * self.block

    @property
    def row_len(self) -> int:
        nbr = self.n // self.block
        if self.nnzb % nbr:
            raise ValueError(f"{self.nnzb} entries do not fill {nbr} block "
                             "rows evenly: pad the rows with zero blocks")
        return self.nnzb // nbr


def _pad_rows(entries, nbr: int):
    """Sort (row, col, payload) entries by row and pad every block row to
    the longest row's length with (row, col, None) zero-block entries; a
    padding entry takes the first column the row does not use yet."""
    by_row = [[] for _ in range(nbr)]
    for e in entries:
        by_row[e[0]].append(e)
    row_len = max(len(r) for r in by_row)
    out = []
    for r, row in enumerate(by_row):
        used = {e[1] for e in row}
        free = (c for c in range(nbr) if c not in used)
        row = sorted(row, key=lambda e: e[1])
        row += [(r, next(free), None) for _ in range(row_len - len(row))]
        out += row
    return out


def bsr_from_dense(a, block: int) -> BSRMatrix:
    """Build a BSR matrix from a dense array, dropping all-zero blocks."""
    a = np.asarray(a)
    n = a.shape[0]
    if n % block or a.shape[0] != a.shape[1]:
        raise ValueError("dense matrix must be square with n % block == 0")
    nbr = n // block
    entries = []
    for r in range(nbr):
        for c in range(nbr):
            blk = a[r * block:(r + 1) * block, c * block:(c + 1) * block]
            if np.any(blk != 0.0):
                entries.append((r, c, blk.T))  # pre-transposed
    entries = _pad_rows(entries, nbr)
    zero = np.zeros((block, block), a.dtype)
    return BSRMatrix(
        blocks_t=jnp.asarray(np.stack(
            [zero if e[2] is None else e[2] for e in entries])),
        rows=jnp.asarray([e[0] for e in entries], jnp.int32),
        cols=jnp.asarray([e[1] for e in entries], jnp.int32),
        n=n,
        block=block,
    )


def bsr_to_dense(m: BSRMatrix):
    """Dense reconstruction (tests/oracles only)."""
    B = m.block
    out = jnp.zeros((m.n, m.n), m.blocks_t.dtype)

    def body(i, acc):
        r, c = m.rows[i], m.cols[i]
        return jax.lax.dynamic_update_slice(
            acc, m.blocks_t[i].T, (r * B, c * B))

    return jax.lax.fori_loop(0, m.nnzb, body, out)


def bsr_diagonal(m: BSRMatrix):
    """(n,) main diagonal — the input to mprec-style preconditioners."""
    nbr, L = m.n // m.block, m.row_len
    is_diag = (m.rows == m.cols).reshape(nbr, L, 1)
    contrib = jnp.diagonal(m.blocks_t, axis1=1, axis2=2).reshape(nbr, L, -1)
    return jnp.sum(jnp.where(is_diag, contrib, 0.0), axis=1).reshape(-1)


def bsr_astype(m: BSRMatrix, dtype) -> BSRMatrix:
    """The same operator with its blocks stored in ``dtype``.

    Mixed-precision ladders run their f32 tier over an f32 store and their
    f64 tier over an f64 store holding the same values (cast up from the
    f32-generated blocks, so the two tiers see one operator)."""
    return dataclasses.replace(m, blocks_t=m.blocks_t.astype(dtype))


def _row_spmm(xb, cols, blocks_t):
    """Row-uniform block SpMM: gather x blocks, one matmul per block row.

    xb: (nbc, k, B) source block-columns; cols: (nbr, L) block column of
    each row's entries; blocks_t: (nbr * L, B, B) pre-transposed blocks in
    row order.  Returns (nbr, k, B).

    The contraction states HIGHEST precision: a GPU may otherwise run an
    f32 matmul in TF32 (about three decimal digits), which would stall the
    f32 tier of a mixed-precision ladder above its handoff tolerance.
    """
    nbr, L = cols.shape
    B = blocks_t.shape[-1]
    gathered = jnp.take(xb, cols, axis=0)                  # (nbr, L, k, B)
    return jnp.einsum("rjkb,rjbc->rkc", gathered,
                      blocks_t.reshape(nbr, L, B, B), precision=_HI)


def bsr_matvec(m: BSRMatrix):
    """Row-block matvec closure ``x: (k, n) -> (k, n)`` for the solvers.

    The product runs in the promoted dtype of ``x`` and the store.
    """
    B = m.block
    nbr = m.n // B
    L = m.row_len

    def mv(x):
        k = x.shape[0]
        xb = x.reshape(k, nbr, B).transpose(1, 0, 2)       # (nbc, k, B)
        out = _row_spmm(xb, m.cols.reshape(nbr, L), m.blocks_t)
        return out.transpose(1, 0, 2).reshape(k, m.n)

    return mv


def random_bsr_spd(n: int, block: int, blocks_per_row: int, key,
                   dtype=jnp.float32, n_low_modes: int = 20,
                   off_scale: float = 0.3) -> BSRMatrix:
    """Random SPD-ish block-sparse test matrix with a dominant diagonal.

    Structure: the block diagonal plus ``blocks_per_row - 1`` symmetric
    off-diagonal block pairs per row (band-ish, deterministic from key).
    Diagonal blocks are made diagonally dominant so the matrix is SPD and
    a shift-and-invert diagonal preconditioner works (mprec-style).
    ``n_low_modes`` diagonal entries are pulled well below the bulk band
    (against one GLOBAL base — per-row bases would bury them in another
    row's bulk at scale) so the low end of the spectrum is a set of
    separated eigenvalues an iterative solver can actually resolve.

    The sparsity pattern is built on the host (tiny); the block *data* is
    generated and assembled on device — at production sizes the blocks are
    gigabytes and a host round-trip would dominate setup time.
    """
    if n % block:
        raise ValueError("n must be divisible by block")
    nbr = n // block
    B = block
    # ---- host: sparsity pattern ----
    pair_set = set()
    for r in range(nbr):
        for jj in range(blocks_per_row - 1):
            c = (r + 1 + jj * max(1, nbr // blocks_per_row)) % nbr
            lo, hi = min(r, c), max(r, c)
            if lo != hi:
                pair_set.add((lo, hi))
    pairs = sorted(pair_set)                      # upper-triangle pairs
    n_pairs = len(pairs)
    # (row, col, (pair, transposed)); pair -1 = diagonal block
    entries = [(r, r, (-1, False)) for r in range(nbr)]
    for pidx, (r, c) in enumerate(pairs):
        entries.append((r, c, (pidx, False)))
        entries.append((c, r, (pidx, True)))
    entries = _pad_rows(entries, nbr)    # padding: pair -2, a zero block
    rows = np.asarray([t[0] for t in entries], np.int32)
    cols = np.asarray([t[1] for t in entries], np.int32)
    pair_of = np.asarray([-2 if t[2] is None else t[2][0] for t in entries],
                         np.int32)
    transposed = np.asarray([t[2] is not None and t[2][1] for t in entries],
                            bool)
    nnzb = len(entries)

    rng = np.random.default_rng(int(jax.random.randint(key, (), 0, 2**31 - 1)))
    low_rows = np.sort(rng.choice(n, size=min(n_low_modes, n), replace=False))
    low_vals = np.linspace(0.5, 4.0, len(low_rows))

    # ---- device: block data (jitted so XLA plans/reuses the multi-GB
    # buffers; run eagerly, the .at[].set assembly chain keeps several
    # full-size temporaries alive at once and OOMs at production sizes) ----
    @jax.jit
    def build(key):
        k_off, k_sym, k_dia = jax.random.split(key, 3)
        scale = jnp.asarray(off_scale / np.sqrt(B), dtype)
        off = scale * jax.random.normal(k_off, (max(n_pairs, 1), B, B), dtype)
        sym = jax.random.normal(k_sym, (nbr, B, B), dtype) * jnp.asarray(
            1.0 / np.sqrt(B), dtype)
        # EXACT symmetry by construction: mirror the strict lower triangle
        # so (i, j) and (j, i) are the same stored value.  The arithmetic
        # identity 0.5*(a + a^T) is exact in IEEE but NOT under jit: XLA
        # fuses the scaling into the two operands differently and the
        # result is asymmetric at f32 eps (observed 3e-8) — enough to
        # spoil a 1e-10 f64 residual target on a nominally SPD operator.
        low = jnp.tril(sym, -1)
        sym = low + low.transpose(0, 2, 1) + jax.vmap(jnp.diag)(
            jnp.diagonal(sym, axis1=1, axis2=2))

        # diagonal dominance: per-row accumulated off-block row/col mass
        row_mass = jnp.max(jnp.sum(jnp.abs(off), axis=2), axis=1)
        col_mass = jnp.max(jnp.sum(jnp.abs(off), axis=1), axis=1)
        p_rows = jnp.asarray([p[0] for p in pairs], jnp.int32)
        p_cols = jnp.asarray([p[1] for p in pairs], jnp.int32)
        boost = jnp.zeros((nbr,), dtype)
        if n_pairs:
            boost = boost.at[p_rows].add(row_mass).at[p_cols].add(col_mass)
        sym_rowmax = jnp.max(jnp.sum(jnp.abs(sym), axis=2), axis=1)
        base = jnp.max(boost + sym_rowmax) + 1.0

        diag_vals = base + 10.0 + 3.0 * jax.random.uniform(k_dia, (n,), dtype)
        diag_vals = diag_vals.at[jnp.asarray(low_rows)].set(
            base + jnp.asarray(low_vals, dtype))
        dia = sym + jax.vmap(jnp.diag)(diag_vals.reshape(nbr, B))

        # assemble blocks_t (entry e stores A(r_e, c_e)^T)
        blocks_t = jnp.zeros((nnzb, B, B), dtype)
        dpos = jnp.asarray(np.nonzero(pair_of == -1)[0], jnp.int32)
        blocks_t = blocks_t.at[dpos].set(dia)  # diagonal blocks: symmetric
        if n_pairs:
            fwd = np.nonzero((pair_of >= 0) & ~transposed)[0]
            bwd = np.nonzero((pair_of >= 0) & transposed)[0]
            # A(r,c) = G  -> store G^T;  A(c,r) = G^T -> store G
            blocks_t = blocks_t.at[jnp.asarray(fwd, jnp.int32)].set(
                off[pair_of[fwd]].transpose(0, 2, 1))
            blocks_t = blocks_t.at[jnp.asarray(bwd, jnp.int32)].set(
                off[pair_of[bwd]])
        return blocks_t

    blocks_t = build(key)

    return BSRMatrix(
        blocks_t=blocks_t,
        rows=jnp.asarray(rows),
        cols=jnp.asarray(cols),
        n=n,
        block=block,
    )
