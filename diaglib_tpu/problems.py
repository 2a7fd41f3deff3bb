"""Toy problem generators replicating the reference test driver.

These reproduce the procedurally generated matrices and callbacks of
``main.f90`` so convergence behavior can be compared 1:1 against the Fortran
binary and against dense ``jnp.linalg`` oracles:

* ``symm_matrix``     — a(i,i) = i+1, a(i,j) = 1/(i+j), 1-based
  (main.f90:311-317).
* ``metric_matrix``   — S = M^T M with M random uniform (main.f90:429-430).
* ``casida_blocks``   — A+B with diag 5+i and off-diag 0.2/(i+j) (the
  reference's loop at main.f90:569-575 overwrites apb's off-diagonals — the
  *converged data* is what we reproduce), A-B diagonal 2+i,
  sigma = I + M^T M, delta antisymmetric random (main.f90:562-597).
* callbacks: dense matvec, shift-and-invert diagonal preconditioner with the
  1e-5 guard (mprec, main.f90:159-168), metric apply, Casida operator applies
  and the two paired diagonal LR preconditioners (main.f90:234-281).

Everything is row-major: operator callbacks map ``x: (k, n) -> (k, n)`` where
rows are vectors.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "symm_matrix",
    "metric_matrix",
    "casida_blocks",
    "nonsym_matrix",
    "dense_matvec",
    "diag_precnd",
    "bsr_casida_tdscf",
    "casida_tdscf_ops",
    "bsr_nonsym_similarity",
    "nonsym_similarity_ops",
    "nonsym_similarity_sided",
    "bsr_gen_problem",
    "lrprec_eff",
    "lrprec_std",
]


def symm_matrix(n: int, dtype=jnp.float64):
    """The Hilbert-like symmetric test matrix (main.f90:311-317)."""
    i = jnp.arange(1, n + 1, dtype=dtype)
    off = 1.0 / (i[:, None] + i[None, :])
    return jnp.fill_diagonal(off, i + 1.0, inplace=False)


def metric_matrix(n: int, key, dtype=jnp.float64):
    """Random SPD metric S = M^T M, M ~ U[0,1) (main.f90:429-430)."""
    m = jax.random.uniform(key, (n, n), dtype=dtype)
    return m.T @ m


def casida_blocks(n: int, key, tdscf: bool = False, dtype=jnp.float64):
    """Casida test blocks (main.f90:562-597).

    Returns dict with apb, amb, sigma, delta, aa, bb, spd, smd.
    With ``tdscf=True``, sigma = I and delta = 0 (test_scflr,
    main.f90:762-794).
    """
    i = jnp.arange(1, n + 1, dtype=dtype)
    apb = 0.2 / (i[:, None] + i[None, :])
    apb = jnp.fill_diagonal(apb, 5.0 + i, inplace=False)
    amb = jnp.diag(2.0 + i)
    if tdscf:
        sigma = jnp.eye(n, dtype=dtype)
        delta = jnp.zeros((n, n), dtype=dtype)
    else:
        k1, k2 = jax.random.split(key)
        m = jax.random.uniform(k1, (n, n), dtype=dtype)
        sigma = m.T @ m + jnp.eye(n, dtype=dtype)
        r = jax.random.uniform(k2, (n, n), dtype=dtype)
        delta = r - r.T
    aa = 0.5 * (apb + amb)
    bb = 0.5 * (apb - amb)
    return dict(
        apb=apb, amb=amb, sigma=sigma, delta=delta,
        aa=aa, bb=bb, spd=sigma + delta, smd=sigma - delta,
    )


def nonsym_matrix(n: int, key, variant: int = 4, dtype=jnp.float64):
    """Nonsymmetric test matrices (test_nonsym, main.f90:941-1092).

    variant 1: P diag(3..n+2) P^{-1}, P = TᵀT SPD from shifted random T
      (main.f90:951-989) — real spectrum {i+2};
    variant 2: symmetric + random perturbation in [0, 0.01] with zero
      diagonal (main.f90:991-1025);
    variant 3: plain symmetric (main.f90:1027-1039);
    variant 4: similarity-transformed symmetric A = e^{-T} S e^{T} with
      random T scaled to ||T||_F = 0.01 (main.f90:1041-1092, the hardcoded
      default) — real spectrum equal to eigh(S).
    """
    if variant == 3:
        return symm_matrix(n, dtype)
    if variant == 1:
        t = jax.random.uniform(key, (n, n), dtype=dtype)
        t = t + jnp.diag(100.0 + jnp.arange(1, n + 1, dtype=dtype))
        p = t.T @ t
        d = jnp.arange(1, n + 1, dtype=dtype) + 2.0
        # A = P diag(d) P^{-1} with P SPD: a Cholesky solve
        cf = jax.scipy.linalg.cho_factor(p)
        m = p * d[None, :]
        return jax.scipy.linalg.cho_solve(cf, m.T).T
    if variant == 2:
        pert = 0.01 * jax.random.uniform(key, (n, n), dtype=dtype)
        pert = pert - jnp.diag(jnp.diagonal(pert))
        return symm_matrix(n, dtype) + pert
    if variant == 4:
        s = symm_matrix(n, dtype)
        t = jax.random.uniform(key, (n, n), dtype=dtype)
        t = t * (0.01 / jnp.linalg.norm(t))
        expt = _matexp_series(t)
        expmt = _matexp_series(-t)
        return expmt @ s @ expt
    raise ValueError(f"unsupported nonsym variant {variant}")


def _matexp_series(t, terms: int = 12):
    """e^T by the truncated Taylor series, like the reference's ``matexp``
    (main.f90:1180-1214).  Matmuls only; ||T|| = 0.01 here, so 12 terms
    reach ~1e-33 truncation (far below f64 eps)."""
    n = t.shape[0]
    acc = jnp.eye(n, dtype=t.dtype)
    term = jnp.eye(n, dtype=t.dtype)
    for k in range(1, terms + 1):
        term = (term @ t) / k
        acc = acc + term
    return acc


def dense_matvec(a):
    """Row-block matvec closure for a dense symmetric-or-not matrix.

    For rows-as-vectors x, (A x_i)_j = sum_k A_jk x_ik, i.e. x @ A.T, at
    HIGHEST precision (a GPU would otherwise run an f32 product in TF32).
    """
    def mv(x):
        return jnp.matmul(x, a.T, precision=jax.lax.Precision.HIGHEST)

    return mv


def diag_precnd(diagonal, guard: float = 1.0e-5):
    """Shift-and-invert diagonal preconditioner (mprec, main.f90:159-168).

    y_i = x_i / (d_i + fac) where |d_i + fac| > guard, else y_i = x_i.
    """
    diagonal = jnp.asarray(diagonal)

    def pc(fac, x):
        denom = diagonal + fac
        safe = jnp.abs(denom) > guard
        return jnp.where(safe[None, :], x / jnp.where(safe, denom, 1.0), x)

    return pc


def lrprec_std(aa_diag, sigma_diag):
    """Paired LR preconditioner for caslr (lrprec_1, main.f90:234-258;
    passed to caslr_driver at main.f90:667-668 with fac = omega).

    yp = -(a*xp + f*s*xm) / (a^2 - f^2 s^2), ym symmetric in xp/xm.
    """
    a = jnp.asarray(aa_diag)
    sg = jnp.asarray(sigma_diag)

    def pc(fac, xp, xm):
        denom = a * a - fac * fac * sg * sg
        denom = _guard_denom(denom, a * a + fac * fac * sg * sg)
        yp = -(a * xp + fac * sg * xm) / denom
        ym = -(a * xm + fac * sg * xp) / denom
        return yp, ym

    return pc


def _guard_denom(denom, scale, rel: float = 1.0e-5):
    """Clamp a preconditioner denominator away from zero (relative to the
    row's magnitude scale) — the mprec guard (main.f90:159-168) extended to
    the paired LR preconditioners: rows resonant with the current root
    (denom -> 0) otherwise produce arbitrarily huge, nearly parallel
    expansion vectors that break the B-metric Cholesky downstream."""
    floor = rel * jnp.maximum(scale, 1.0)
    return jnp.where(jnp.abs(denom) < floor,
                     jnp.where(denom < 0.0, -floor, floor), denom)


def bsr_casida_tdscf(n: int, block: int, blocks_per_row: int, key):
    """Flagship-scale Casida problem on plain BSR operators.

    TD-SCF structure (test_scflr protocol, main.f90:732-908 at production
    scale): sigma = I, delta = 0, so spd = smd = identity and the heavy
    operators are A+B and A-B — two independent SPD block-sparse matrices.

    Returns ``(lo, hi)``: ``(apb, amb)`` store pairs for the f32 and f64
    tiers of the mixed-precision LR ladder (solvers/mixed.py).  The f64
    stores hold the f32-generated values cast up, so both tiers see one
    operator.  Pass them as jit ARGUMENTS and build each tier's
    :class:`~diaglib_tpu.types.LROps` inside with :func:`casida_tdscf_ops`.
    """
    from .ops.bsr import bsr_astype, random_bsr_spd

    # A+B and A-B share the diagonal (and its separated low modes) and
    # differ in off-diagonal strength: with independent operators the low
    # modes land on different rows and the product spectrum w^2 ~
    # eig(A+B) eig(A-B) has no diagonal-resolvable low excitations — the
    # paired diagonal preconditioner then stalls (observed at n=65536).
    apb = random_bsr_spd(n, block, blocks_per_row, key, dtype=jnp.float32,
                         off_scale=0.3)
    amb = random_bsr_spd(n, block, blocks_per_row, key, dtype=jnp.float32,
                         off_scale=0.15)
    hi = tuple(bsr_astype(m, jnp.float64) for m in (apb, amb))
    return (apb, amb), hi


def casida_tdscf_ops(apb, amb, prec: str = "eff"):
    """One LROps tier over BSR (A+B)/(A-B) stores, in the stores' dtype.

    Jit-traceable: call INSIDE a jitted function whose arguments are the
    two store pytrees — closing over multi-GB operators instead bakes them
    into the program as constants.  ``prec``: "eff" pairs the bundle with
    the caslr_eff preconditioner (lrprec_2, called with 1/w); "std" with
    the caslr one (lrprec_1, called with w) for the S4 driver."""
    from .ops.bsr import bsr_diagonal, bsr_matvec
    from .types import LROps

    diag_aa = 0.5 * (bsr_diagonal(apb) + bsr_diagonal(amb))
    ident = lambda x: x  # noqa: E731 — sigma = I, delta = 0 (tdscf)
    make_prec = lrprec_eff if prec == "eff" else lrprec_std
    return LROps(
        apbmul=bsr_matvec(apb),
        ambmul=bsr_matvec(amb),
        spdmul=ident, smdmul=ident,
        lrprec=make_prec(diag_aa, jnp.ones_like(diag_aa)),
    )


def lrprec_eff(aa_diag, sigma_diag):
    """Paired LR preconditioner for caslr_eff (lrprec_2, main.f90:260-281;
    passed to caslr_eff_driver at main.f90:715-716 with fac = 1/omega).

    denom = f^2 a^2 - s^2; yp = (f*a*xp + s*xm)/denom, ym symmetric.
    """
    a = jnp.asarray(aa_diag)
    sg = jnp.asarray(sigma_diag)

    def pc(fac, xp, xm):
        denom = fac * fac * a * a - sg * sg
        denom = _guard_denom(denom, fac * fac * a * a + sg * sg)
        yp = (fac * a * xp + sg * xm) / denom
        ym = (fac * a * xm + sg * xp) / denom
        return yp, ym

    return pc


def _band_bsr(n: int, block: int, key, scale: float, dtype=jnp.float32):
    """One-off-diagonal-band BSR matrix (rows r hold block (r, r+1 mod nbr))
    with iid normal blocks scaled to total Frobenius norm ``scale``."""
    import numpy as np

    from .ops.bsr import BSRMatrix

    nbr = n // block
    nnz = nbr * block * block
    c = scale / float(np.sqrt(nnz))
    blocks = c * jax.random.normal(key, (nbr, block, block), dtype)
    rows = jnp.arange(nbr, dtype=jnp.int32)
    cols = (rows + 1) % nbr
    return BSRMatrix(blocks_t=blocks.transpose(0, 2, 1), rows=rows,
                     cols=cols, n=n, block=block)


def _bsr_transpose_band(t):
    """Transpose of a one-band BSR from _band_bsr (entry (r, r+1) becomes
    (r+1, r); entries stay row-sorted)."""
    import numpy as np

    from .ops.bsr import BSRMatrix

    nbr = t.n // t.block
    # entry e of t is (e, e+1 mod nbr); its transpose lives at row
    # (e+1 mod nbr) — reorder entries so rows are ascending again
    order = jnp.argsort((t.rows + 1) % nbr)
    rows = jnp.arange(nbr, dtype=jnp.int32)
    return BSRMatrix(
        blocks_t=t.blocks_t[order].transpose(0, 2, 1),
        rows=rows,
        cols=(rows - 1) % nbr,
        n=t.n,
        block=t.block,
    )


def bsr_nonsym_similarity(n: int, block: int, blocks_per_row: int, key,
                          t_scale: float = 0.01):
    """Flagship-scale nonsymmetric problem: similarity-transformed
    symmetric operator, matrix-free (the reference's variant-4
    construction, main.f90:1041-1092, at production scale).

    R = E_- S E_+ with S an SPD BSR operator, E_± the order-4 truncated
    series of e^{±T}, and T a one-band BSR scaled to ||T||_F = ``t_scale``
    (the reference's 0.01).  E_- is the series of -T, NOT the inverse of
    the truncated E_+, so R is similar to S only up to O(||T||^5/120) ~
    1e-19 — far below f64; the spectrum is real and equals eig(S) to
    machine precision, exactly the variant-4 contract.  The LEFT operator
    is the exact transpose R^T = E_+^T S E_-^T, applied through the store
    of T^T.

    Returns ``(lo, hi)``: ``(s, t, tt)`` BSR stores for the f32 and f64
    tiers (the f64 stores hold the f32-generated values cast up).  Pass
    them as jit ARGUMENTS and build the closures inside with
    :func:`nonsym_similarity_ops`; S's diagonal (``bsr_diagonal(s)``)
    preconditions, since diag(R) = diag(S) + O(||T||).
    """
    from .ops.bsr import bsr_astype, random_bsr_spd

    ks, kt = jax.random.split(key)
    s = random_bsr_spd(n, block, blocks_per_row, ks, dtype=jnp.float32)
    t = _band_bsr(n, block, kt, t_scale)
    lo = (s, t, _bsr_transpose_band(t))
    return lo, tuple(bsr_astype(m, jnp.float64) for m in lo)


def nonsym_similarity_ops(stores, terms: int = 4):
    """(matvec, matvec_l) closures over the similarity stores, in the
    stores' dtype.

    Jit-traceable: call INSIDE a jitted function whose arguments are the
    three BSR stores (never close over multi-GB stores).  ``terms``=4 keeps
    the e^{±T} truncation at ||T||^5/120 ~ 1e-19 for ||T|| = 0.01.
    """
    s, t, tt = stores
    return (nonsym_similarity_sided(s, t, 1.0, terms),
            nonsym_similarity_sided(s, tt, -1.0, terms))


def nonsym_similarity_sided(s_store, t_store, sign, terms: int = 4):
    """ONE side-polymorphic matvec closure over the similarity stores.

    The right operator R = E_- S E_+ and its transpose R^T = E_+^T S E_-^T
    are the SAME compute graph fed different data: ``t_store`` is the
    store of T (right) or T^T (left) and ``sign`` (may be a traced
    scalar) is +1 for right, -1 for left.  Together with a traced
    ``use_left`` in :func:`~diaglib_tpu.solvers.nonsym_pass` this lets one
    compiled pass program serve both sides of the consecutive protocol,
    halving the pass programs' compile cost.
    """
    from .ops.bsr import bsr_matvec

    smv = bsr_matvec(s_store)
    tmv = bsr_matvec(t_store)
    sign = jnp.asarray(sign, s_store.blocks_t.dtype)

    def exp_apply(x, sgn):
        term, acc = x, x
        for j in range(1, terms + 1):
            term = tmv(term) * (sgn / j)
            acc = acc + term
        return acc

    def mv(x):
        return exp_apply(smv(exp_apply(x, sign)), -sign)

    return mv


def bsr_gen_problem(n: int, block: int, blocks_per_row: int, key,
                    metric_blocks_per_row: int = 4):
    """Flagship-scale generalized eigenproblem A x = lambda B x on plain
    BSR operators (gen_david_driver / generalized LOBPCG semantics,
    diaglib.f90:1855-2250 and 299-302, at production scale).

    A is the flagship SPD operator (separated low modes); B is an
    independent diagonally-dominant SPD operator (same builder, milder
    off-diagonals) — a well-conditioned metric, like the reference's
    S = M^T M (main.f90:429-430) but block-sparse.

    Returns ``(lo, hi)``: ``(a, b)`` BSR stores for the f32 and f64 tiers
    (the f64 stores hold the f32-generated values cast up); pass them as
    jit ARGUMENTS and build matvec/bvec inside with ``bsr_matvec``.
    """
    from .ops.bsr import bsr_astype, random_bsr_spd

    ka, kb = jax.random.split(key, 2)
    a = random_bsr_spd(n, block, blocks_per_row, ka, dtype=jnp.float32)
    b = random_bsr_spd(n, block, metric_blocks_per_row, kb,
                       dtype=jnp.float32, off_scale=0.1, n_low_modes=0)
    return (a, b), (bsr_astype(a, jnp.float64), bsr_astype(b, jnp.float64))
