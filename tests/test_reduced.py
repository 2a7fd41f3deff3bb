"""Tests for the reduced-solver backends: jacobi vs jnp.linalg oracles, the
host-callback path, and solvers running end-to-end with each method."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diaglib_tpu import SolverOptions
from diaglib_tpu.problems import dense_matvec, diag_precnd, symm_matrix
from diaglib_tpu.solvers import davidson
from diaglib_tpu.utils import reduced
from diaglib_tpu.utils.jacobi import jacobi_eigh, jacobi_svd

KEY = jax.random.PRNGKey(0)


def _sym(k, n=97):
    a = jax.random.normal(KEY, (n, n), jnp.float64)
    return 0.5 * (a + a.T)


@pytest.mark.parametrize("n", [16, 97, 128])
def test_jacobi_eigh_matches_lapack(n):
    a = _sym(0, n)
    w, v = jacobi_eigh(a)
    w0 = jnp.linalg.eigh(a)[0]
    np.testing.assert_allclose(np.asarray(w), np.asarray(w0), atol=1e-11)
    # eigen-residuals and orthonormality
    res = a @ v - v * w[None, :]
    assert float(jnp.max(jnp.abs(res))) < 1e-10
    np.testing.assert_allclose(np.asarray(v.T @ v), np.eye(n), atol=1e-12)


def test_jacobi_eigh_under_jit_and_loop():
    a = _sym(0, 64)

    @jax.jit
    def f(m):
        def body(c):
            i, x = c
            w, v = jacobi_eigh(x)
            return i + 1, v @ jnp.diag(w) @ v.T

        return jax.lax.while_loop(lambda c: c[0] < 2, body, (0, m))[1]

    out = f(a)
    np.testing.assert_allclose(np.asarray(out), np.asarray(a), atol=1e-10)


@pytest.mark.parametrize("n", [17, 64])
def test_jacobi_svd_matches_lapack(n):
    a = jax.random.normal(jax.random.PRNGKey(3), (n, n), jnp.float64)
    u, s, vt = jacobi_svd(a)
    s0 = jnp.linalg.svd(a, compute_uv=False)
    np.testing.assert_allclose(np.asarray(s), np.asarray(s0), atol=1e-11)
    rec = (u * s[None, :]) @ vt
    np.testing.assert_allclose(np.asarray(rec), np.asarray(a), atol=1e-10)


def test_eigh_gen_jacobi_matches_scipy():
    import scipy.linalg

    n = 48
    s = _sym(0, n)
    b = jax.random.normal(jax.random.PRNGKey(5), (n, n), jnp.float64)
    a = b @ b.T + n * jnp.eye(n)
    e, x = reduced.eigh_gen(s, a, "jacobi")
    e0 = scipy.linalg.eigh(np.asarray(s), np.asarray(a), eigvals_only=True)
    np.testing.assert_allclose(np.asarray(e), e0, atol=1e-10)
    np.testing.assert_allclose(np.asarray(x.T @ a @ x), np.eye(n), atol=1e-9)


def test_host_callback_path():
    a = _sym(0, 32)
    w, v = reduced.eigh(a, "host")
    w0 = jnp.linalg.eigh(a)[0]
    np.testing.assert_allclose(np.asarray(w), np.asarray(w0), atol=1e-12)


@pytest.mark.parametrize("method", ["device", "host", "jacobi"])
def test_davidson_with_each_reduced_solver(method):
    n, n_want, n_eig = 200, 4, 8
    a = symm_matrix(n)
    w = jnp.linalg.eigh(a)[0]
    opts = SolverOptions(n_targ=n_want, n_max=n_eig, max_iter=100, tol=1e-8,
                         max_dav=10, reduced_solver=method)
    res = davidson(dense_matvec(a), diag_precnd(jnp.diagonal(a)),
                   jnp.zeros((n_eig, n), jnp.float64), opts,
                   key=jax.random.PRNGKey(11))
    assert bool(res.ok), method
    np.testing.assert_allclose(np.asarray(res.eig[:n_want]),
                               np.asarray(w[:n_want]), rtol=0, atol=1e-7)


def test_bad_method():
    with pytest.raises(ValueError):
        reduced.eigh(jnp.eye(4), "bogus")


@pytest.mark.parametrize("k", [100, 4096, 5000, 16384])
def test_mm_helpers_match_numpy(k):
    """mm/mmT/mTm must agree with numpy at any contraction length (the
    chunked x2-scaled f64 contraction must not change results)."""
    from diaglib_tpu.utils.mm import mm, mmT, mTm

    rng = np.random.default_rng(0)
    a = rng.standard_normal((7, k))
    b = rng.standard_normal((5, k))
    np.testing.assert_allclose(np.asarray(mmT(jnp.asarray(a), jnp.asarray(b))),
                               a @ b.T, rtol=1e-12, atol=1e-11)
    c = rng.standard_normal((k, 6))
    np.testing.assert_allclose(np.asarray(mm(jnp.asarray(a), jnp.asarray(c))),
                               a @ c, rtol=1e-12, atol=1e-11)
    d = rng.standard_normal((k, 4))
    np.testing.assert_allclose(np.asarray(mTm(jnp.asarray(c), jnp.asarray(d))),
                               c.T @ d, rtol=1e-12, atol=1e-11)


def test_jacobi_tiny_sizes():
    """1x1 and 2x2 inputs (reachable via n_max=1 solvers and bucket lo=2)
    must not crash the Brent-Luk slicing (regression: slice_in_dim(1, 0))."""
    from diaglib_tpu.utils.jacobi import jacobi_eigh, jacobi_svd

    a2 = jnp.asarray([[2.0, 1.0], [1.0, 3.0]])
    w, v = jacobi_eigh(a2)
    np.testing.assert_allclose(np.asarray(w), np.linalg.eigh(np.asarray(a2))[0],
                               atol=1e-12)
    a1 = jnp.asarray([[4.0]])
    w1, v1 = jacobi_eigh(a1)
    np.testing.assert_allclose(np.asarray(w1), [4.0], atol=1e-14)
    u, s, vt = jacobi_svd(jnp.asarray([[-3.0]]))
    np.testing.assert_allclose(np.asarray(s), [3.0], atol=1e-14)


def test_f32_svd_routes_and_matches():
    """reduced.svd's f32 route ("auto" = jnp.linalg) and the Jacobi SVD
    both produce correct f32 results, pinned against the f64 oracle."""
    import numpy as np

    from diaglib_tpu.utils import jacobi, reduced

    rng = np.random.default_rng(7)
    a64 = rng.standard_normal((15, 15))
    a32 = jnp.asarray(a64, jnp.float32)
    s_ref = np.linalg.svd(a64, compute_uv=False)

    assert reduced.resolve("auto") == "device"
    u, s, vt = reduced.svd(a32)
    np.testing.assert_allclose(np.asarray(s), s_ref, rtol=2e-5)
    rec = np.asarray(u) @ np.diag(np.asarray(s)) @ np.asarray(vt)
    np.testing.assert_allclose(rec, a64, atol=2e-5 * s_ref[0])

    uj, sj, vtj = jacobi.jacobi_svd(a32)
    np.testing.assert_allclose(np.asarray(sj), s_ref, rtol=2e-4)
    recj = np.asarray(uj) @ np.diag(np.asarray(sj)) @ np.asarray(vtj)
    np.testing.assert_allclose(recj, a64, atol=2e-4 * s_ref[0])


def test_jacobi_eigh_warm_start_matches():
    """Warm-started Jacobi (v0 = eigenvectors of a nearby matrix) must
    reproduce the oracle decomposition of the perturbed matrix (round-4:
    solvers seed each iteration's reduced solve with the previous one)."""
    import jax

    key = jax.random.PRNGKey(7)
    L = 40
    a = jax.random.normal(key, (L, L), jnp.float64)
    a = jnp.tril(a) + jnp.tril(a, -1).T
    w1, v1 = jacobi_eigh(a)
    da = 1e-3 * jax.random.normal(jax.random.PRNGKey(8), (L, L), jnp.float64)
    a2 = a + jnp.tril(da) + jnp.tril(da, -1).T
    # single-phase path: the mixed path ignores v0 (see jacobi_eigh doc)
    w2, v2 = jacobi_eigh(a2, v0=v1, mixed_precision=False)
    w_ref = jnp.linalg.eigh(a2)[0]
    assert float(jnp.max(jnp.abs(w2 - w_ref))) < 1e-12
    # eigenvectors: residual check (phase-free)
    r = a2 @ v2 - v2 * w2[None, :]
    assert float(jnp.max(jnp.abs(r))) < 1e-11
    # orthonormality preserved through the warm-start composition
    err = jnp.max(jnp.abs(v2.T @ v2 - jnp.eye(L)))
    assert float(err) < 1e-12


def test_jacobi_eigh_off_tol_relaxed():
    import jax

    a = jax.random.normal(jax.random.PRNGKey(3), (31, 31), jnp.float64)
    a = jnp.tril(a) + jnp.tril(a, -1).T
    w, v = jacobi_eigh(a, off_tol=1e-13)
    w_ref = jnp.linalg.eigh(a)[0]
    # reduced-solve error budget: 3+ orders below a 1e-8..1e-10 solver tol
    assert float(jnp.max(jnp.abs(w - w_ref))) < 1e-11
    r = a @ v - v * w[None, :]
    assert float(jnp.max(jnp.abs(r))) < 1e-10


def test_masked_eigh_bucketed_warm_growing_prefix():
    """The davidson usage pattern: solve a prefix, grow it by a block,
    warm-start the next solve with the previous full-width eigenvectors
    (zero columns auto-filled with identity)."""
    import jax

    from diaglib_tpu.utils.masking import masked_eigh_bucketed, prefix_mask

    full, lo = 48, 12
    a = jax.random.normal(jax.random.PRNGKey(5), (full, full), jnp.float64)
    a = jnp.tril(a) + jnp.tril(a, -1).T
    v_prev = None
    for ldu in (10, 14, 26, 40):
        mask = prefix_mask(full, jnp.asarray(ldu, jnp.int32))
        w, v = masked_eigh_bucketed(a, mask, jnp.asarray(ldu, jnp.int32),
                                    lo, method="jacobi", v0=v_prev,
                                    off_tol=1e-13)
        w_ref = jnp.linalg.eigh(a[:ldu, :ldu])[0]
        assert float(jnp.max(jnp.abs(w[:ldu] - w_ref))) < 1e-10, ldu
        v_prev = v


def test_jacobi_svd_onesided_matches_lapack():
    """One-sided (Hestenes) Jacobi SVD vs jnp.linalg.svd: singular values
    to full relative accuracy even with a 1e6 condition number (column
    norms, no Gram squaring), orthonormal factors, exact reconstruction."""
    import jax

    from diaglib_tpu.utils.jacobi import jacobi_svd_onesided

    for L, seed in ((40, 0), (41, 1)):
        a = jax.random.normal(jax.random.PRNGKey(seed), (L, L), jnp.float64)
        u0, s0, vt0 = jnp.linalg.svd(a)
        a = (u0 * jnp.logspace(0, -6, L)[None, :]) @ vt0
        u, s, vt = jacobi_svd_onesided(a)
        sr = jnp.linalg.svd(a, compute_uv=False)
        assert float(jnp.max(jnp.abs(s - sr) / sr)) < 1e-10
        assert float(jnp.max(jnp.abs(u @ jnp.diag(s) @ vt - a))) < 1e-14
        eye = jnp.eye(L)
        assert float(jnp.max(jnp.abs(u.T @ u - eye))) < 1e-13
        assert float(jnp.max(jnp.abs(vt @ vt.T - eye))) < 1e-13
