"""BSR operator tests: dense agreement, stated precision, solver
integration."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diaglib_tpu import SolverOptions
from diaglib_tpu.ops import (
    bsr_astype,
    bsr_from_dense,
    bsr_matvec,
    bsr_to_dense,
    random_bsr_spd,
)
from diaglib_tpu.problems import _band_bsr, diag_precnd
from diaglib_tpu.solvers import davidson

KEY = jax.random.PRNGKey(0)


def test_bsr_roundtrip():
    n, B = 64, 16
    dense = np.zeros((n, n))
    rng = np.random.default_rng(0)
    for (r, c) in [(0, 0), (1, 1), (2, 2), (3, 3), (0, 2), (2, 0)]:
        dense[r * B:(r + 1) * B, c * B:(c + 1) * B] = rng.standard_normal((B, B))
    m = bsr_from_dense(dense, B)
    np.testing.assert_allclose(np.asarray(bsr_to_dense(m)), dense, atol=0)


def test_bsr_reference_matvec_matches_dense():
    m = random_bsr_spd(256, 32, 3, KEY, dtype=jnp.float64)
    dense = np.asarray(bsr_to_dense(m))
    np.testing.assert_allclose(dense, dense.T, atol=1e-12)  # symmetric
    x = jax.random.normal(jax.random.PRNGKey(1), (5, 256), jnp.float64)
    y = bsr_matvec(m)(x)
    np.testing.assert_allclose(np.asarray(y), np.asarray(x) @ dense.T,
                               rtol=1e-12, atol=1e-12)


def _pattern(name, n, block, dtype):
    if name == "spd":
        return random_bsr_spd(n, block, 3, KEY, dtype=dtype)
    return bsr_astype(_band_bsr(n, block, KEY, 3.0), dtype)


@pytest.mark.parametrize("pattern", ["spd", "band"])
@pytest.mark.parametrize("block", [8, 32])
@pytest.mark.parametrize("k", [1, 15, 16])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_spmm_matches_dense(dtype, k, block, pattern):
    """The plain SpMM (gather, one matmul per block row) against a dense
    f64 product of the same stored values, for every dtype, vector count,
    block size and sparsity pattern the solvers use."""
    dtype = jnp.dtype(dtype)
    n = 8 * block
    m = _pattern(pattern, n, block, dtype)
    dense = np.asarray(bsr_to_dense(m), np.float64)
    x = jax.random.normal(jax.random.PRNGKey(3), (k, n), dtype)
    y = jax.jit(lambda m, x: bsr_matvec(m)(x))(m, x)
    assert y.shape == (k, n) and y.dtype == dtype
    ref = np.asarray(x, np.float64) @ dense.T
    # f32: products summed over block * row-entries terms in f32
    tol = 1e-12 if dtype == jnp.float64 else 1e-5
    np.testing.assert_allclose(np.asarray(y, np.float64), ref,
                               atol=tol * np.max(np.abs(ref)))


def test_bsr_spd_and_davidson():
    """End-to-end: Davidson on the BSR operator vs dense eigh."""
    m = random_bsr_spd(512, 32, 3, KEY, dtype=jnp.float64)
    dense = bsr_to_dense(m)
    w = jnp.linalg.eigh(dense)[0]
    diag = jnp.diagonal(dense)
    opts = SolverOptions(n_targ=4, n_max=8, max_iter=200, tol=1e-8, max_dav=10)
    res = davidson(bsr_matvec(m), diag_precnd(diag),
                   jnp.zeros((8, 512), jnp.float64), opts,
                   key=jax.random.PRNGKey(5))
    assert bool(res.ok)
    np.testing.assert_allclose(np.asarray(res.eig[:4]), np.asarray(w[:4]),
                               rtol=0, atol=1e-7)


def test_empty_block_row_returns_zeros():
    """A block row with no nonzero block is padded with a zero block (every
    row holds row_len entries) and produces zero output columns."""
    n, B = 8 * 16, 16
    dense = np.zeros((n, n))
    rng = np.random.default_rng(0)
    for r in (0, 2, 3, 5, 7):  # rows 1, 4, 6 left empty
        dense[r*B:(r+1)*B, r*B:(r+1)*B] = rng.standard_normal((B, B))
    m = bsr_from_dense(jnp.asarray(dense, jnp.float32), B)
    assert m.row_len == 1 and m.nnzb == 8
    x = jnp.asarray(rng.standard_normal((3, n)), jnp.float32)
    y_ref = np.asarray(x, np.float64) @ dense.T
    y = bsr_matvec(m)(x)
    np.testing.assert_allclose(np.asarray(y, np.float64), y_ref,
                               atol=1e-5 * max(1.0, np.max(np.abs(y_ref))))
    for r in (1, 4, 6):
        assert float(jnp.max(jnp.abs(y[:, r*B:(r+1)*B]))) == 0.0


def _dot_precisions(fn, *args):
    """Precision of every dot_general in fn's jaxpr, sub-jaxprs included."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found


def _highest(p):
    hi = jax.lax.Precision.HIGHEST
    return p == (hi, hi) or p == hi


@pytest.mark.parametrize("name", ["mm", "mmT", "mTm", "bsr_f32"])
def test_contractions_state_highest_precision(name):
    """Every solver contraction and the f32 BSR matvec ask for HIGHEST
    precision, so a GPU cannot silently run them in TF32."""
    from diaglib_tpu.utils import mm as mmod

    f32 = jnp.float32
    a = jnp.ones((4, 8192), f32)  # long enough to cover any chunked path
    if name == "mm":
        precs = _dot_precisions(mmod.mm, jnp.ones((4, 8192)),
                                jnp.ones((8192, 3)))
    elif name == "mmT":
        precs = _dot_precisions(mmod.mmT, jnp.ones((4, 8192)),
                                jnp.ones((3, 8192)))
    elif name == "mTm":
        precs = _dot_precisions(mmod.mTm, jnp.ones((8192, 4)), a.T)
    else:
        m = random_bsr_spd(64, 8, 2, KEY, dtype=f32)
        precs = _dot_precisions(lambda x: bsr_matvec(m)(x),
                                jnp.ones((3, 64), f32))
    assert precs, "no dot_general traced"
    assert all(_highest(p) for p in precs), precs
