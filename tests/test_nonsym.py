"""Two-sided nonsymmetric Davidson tests (test_nonsym protocol,
main.f90:910-1178: similarity-transformed symmetric matrix, side='c')."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg

from diaglib_tpu import SolverOptions
from diaglib_tpu.problems import dense_matvec, diag_precnd, nonsym_matrix
from diaglib_tpu.solvers import nonsym
from diaglib_tpu.utils.guess import guess_evec

N = 200
N_WANT = 5
TOL = 1e-8


@pytest.fixture(scope="module")
def problem():
    a = nonsym_matrix(N, jax.random.PRNGKey(1), variant=4)
    w, vl, vr = scipy.linalg.eig(np.asarray(a), left=True, right=True)
    order = np.argsort(w.real)
    w = w[order].real
    vr = vr[:, order].real
    vl = vl[:, order].real
    return a, jnp.asarray(w), vr, vl


def _guess(a, n_rows, key=7):
    diag = jnp.diagonal(a)
    return guess_evec(6, jax.random.PRNGKey(key), N, n_rows, diagonal=diag)


def test_nonsym_right_only(problem):
    a, w, vr, _ = problem
    opts = SolverOptions(n_targ=N_WANT, n_max=N_WANT, max_iter=200, tol=TOL,
                         max_dav=10)
    res = nonsym(dense_matvec(a), dense_matvec(a.T), diag_precnd(jnp.diagonal(a)),
                 _guess(a, N_WANT), opts, side="r", key=jax.random.PRNGKey(2))
    assert bool(res.ok)
    np.testing.assert_allclose(np.asarray(res.eig[:N_WANT]),
                               np.asarray(w[:N_WANT]), rtol=0, atol=1e-7)
    for i in range(N_WANT):
        v = np.asarray(res.evec_r[i])
        overlap = abs(v @ vr[:, i]) / np.linalg.norm(v) / np.linalg.norm(vr[:, i])
        assert overlap > 1 - 1e-6


def test_nonsym_left_only(problem):
    a, w, _, vl = problem
    opts = SolverOptions(n_targ=N_WANT, n_max=N_WANT, max_iter=200, tol=TOL,
                         max_dav=10)
    res = nonsym(dense_matvec(a), dense_matvec(a.T), diag_precnd(jnp.diagonal(a)),
                 _guess(a, N_WANT), opts, side="l", key=jax.random.PRNGKey(2))
    assert bool(res.ok)
    np.testing.assert_allclose(np.asarray(res.eig[:N_WANT]),
                               np.asarray(w[:N_WANT]), rtol=0, atol=1e-7)
    for i in range(N_WANT):
        v = np.asarray(res.evec_l[i])
        overlap = abs(v @ vl[:, i]) / np.linalg.norm(v) / np.linalg.norm(vl[:, i])
        assert overlap > 1 - 1e-6


def test_nonsym_consecutive(problem):
    """side='c': right pass, left pass, eigenvalue cross-check, final
    svd_biortho so that evec_l @ evec_r^T = I."""
    a, w, _, _ = problem
    opts = SolverOptions(n_targ=N_WANT, n_max=N_WANT, max_iter=200, tol=TOL,
                         max_dav=10)
    res = nonsym(dense_matvec(a), dense_matvec(a.T), diag_precnd(jnp.diagonal(a)),
                 _guess(a, N_WANT), opts, side="c", key=jax.random.PRNGKey(2))
    assert bool(res.ok)
    np.testing.assert_allclose(np.asarray(res.eig[:N_WANT]),
                               np.asarray(w[:N_WANT]), rtol=0, atol=1e-7)
    # biorthonormality after svd_biortho
    g = res.evec_l @ res.evec_r.T
    np.testing.assert_allclose(np.asarray(g), np.eye(N_WANT), atol=1e-8)
    # residuals on both sides
    for i in range(N_WANT):
        rr = a @ res.evec_r[i] - res.eig[i] * res.evec_r[i]
        rl = a.T @ res.evec_l[i] - res.eig[i] * res.evec_l[i]
        nr = float(jnp.linalg.norm(rr)) / float(jnp.linalg.norm(res.evec_r[i]))
        nl = float(jnp.linalg.norm(rl)) / float(jnp.linalg.norm(res.evec_l[i]))
        assert nr < 1e-6 and nl < 1e-6


def test_nonsym_symmetric_variant(problem):
    """variant 3 (plain symmetric) must agree with eigh."""
    a3 = nonsym_matrix(N, jax.random.PRNGKey(0), variant=3)
    w = jnp.linalg.eigh(a3)[0]
    opts = SolverOptions(n_targ=4, n_max=4, max_iter=200, tol=TOL, max_dav=10)
    res = nonsym(dense_matvec(a3), dense_matvec(a3.T),
                 diag_precnd(jnp.diagonal(a3)), _guess(a3, 4), opts,
                 side="r", key=jax.random.PRNGKey(4))
    assert bool(res.ok)
    np.testing.assert_allclose(np.asarray(res.eig[:4]), np.asarray(w[:4]),
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("variant", [1, 2])
def test_nonsym_other_variants(variant):
    """variants 1 (P diag P^-1) and 2 (perturbed symmetric) vs dense eig."""
    a = nonsym_matrix(N, jax.random.PRNGKey(0), variant=variant)
    w = np.sort(scipy.linalg.eig(np.asarray(a), right=False).real)
    opts = SolverOptions(n_targ=4, n_max=4, max_iter=200, tol=TOL, max_dav=10)
    res = nonsym(dense_matvec(a), dense_matvec(a.T),
                 diag_precnd(jnp.diagonal(a)), _guess(a, 4), opts,
                 side="r", key=jax.random.PRNGKey(4))
    assert bool(res.ok)
    np.testing.assert_allclose(np.asarray(res.eig[:4]), np.asarray(w[:4]),
                               rtol=0, atol=1e-6)


def test_nonsym_bad_side(problem):
    a, _, _, _ = problem
    opts = SolverOptions(n_targ=2, n_max=2)
    with pytest.raises(ValueError):
        nonsym(dense_matvec(a), dense_matvec(a.T),
               diag_precnd(jnp.diagonal(a)), _guess(a, 2), opts, side="x")


def test_host_driver_matches_jit_driver():
    """driver='host' (Python-orchestrated loop for callback-less PJRT
    runtimes) must reproduce the jit driver."""
    import numpy as np

    from diaglib_tpu.problems import (
        dense_matvec,
        diag_precnd,
        nonsym_matrix,
    )

    a = nonsym_matrix(200, variant=4, key=jax.random.PRNGKey(1))
    diag = jnp.diagonal(a)
    opts = SolverOptions(n_targ=4, n_max=4, max_iter=200, tol=1e-8,
                         max_dav=10)
    guess = jnp.zeros((4, 200), jnp.float64)
    kw = dict(side="c", key=jax.random.PRNGKey(3))
    res_j = nonsym(dense_matvec(a), dense_matvec(a.T), diag_precnd(diag),
                   guess, opts, driver="jit", **kw)
    res_h = nonsym(dense_matvec(a), dense_matvec(a.T), diag_precnd(diag),
                   guess, opts, driver="host", **kw)
    assert bool(res_j.ok) and bool(res_h.ok)
    # the two drivers compile differently (one fused program vs two), so
    # assert the contract (same converged eigenvalues), not bitwise paths
    np.testing.assert_allclose(np.asarray(res_h.eig[:4]),
                               np.asarray(res_j.eig[:4]), rtol=0, atol=1e-10)


def test_device_driver_matches_jit_driver():
    """driver='device' (reduced solve fully on device via the Eberlein
    norm-reducing Jacobi, utils/eberlein.py — the path for callback-less
    PJRT runtimes) must reproduce the host-dgeev
    jit driver on the reference protocol (variant 4, side='c')."""
    a = nonsym_matrix(200, variant=4, key=jax.random.PRNGKey(1))
    diag = jnp.diagonal(a)
    opts = SolverOptions(n_targ=4, n_max=4, max_iter=200, tol=1e-8,
                         max_dav=10)
    guess = jnp.zeros((4, 200), jnp.float64)
    kw = dict(side="c", key=jax.random.PRNGKey(3))
    res_j = nonsym(dense_matvec(a), dense_matvec(a.T), diag_precnd(diag),
                   guess, opts, driver="jit", **kw)
    res_d = nonsym(dense_matvec(a), dense_matvec(a.T), diag_precnd(diag),
                   guess, opts, driver="device", **kw)
    assert bool(res_j.ok) and bool(res_d.ok)
    # different reduced eigensolvers (LAPACK dgeev vs Eberlein sweeps) →
    # different iteration paths; the contract is the converged eigenpairs
    np.testing.assert_allclose(np.asarray(res_d.eig[:4]),
                               np.asarray(res_j.eig[:4]), rtol=0, atol=1e-9)
    g = res_d.evec_l @ res_d.evec_r.T
    np.testing.assert_allclose(np.asarray(g), np.eye(4), atol=1e-8)


def test_complex_pairs_parked():
    """A genuinely complex spectrum above the target window: the reduced
    dgeev produces complex pairs that sort_eigenpairs parks at the tail
    (diaglib.f90:2984-3006, tol_im=1e-12), so the real targeted roots
    converge undisturbed."""
    n_sym, n_rot = 180, 10
    s = np.asarray(nonsym_matrix(n_sym, jax.random.PRNGKey(0), variant=3),
                   np.float64)
    rng = np.random.default_rng(3)
    blocks = [np.array([[40.0 + 3.0 * i, 5.0 + 0.5 * i],
                        [-(5.0 + 0.5 * i), 40.0 + 3.0 * i]])
              for i in range(n_rot)]
    a = scipy.linalg.block_diag(s, *blocks)
    q = np.linalg.qr(rng.standard_normal((a.shape[0],) * 2))[0]
    a = q.T @ a @ q
    w = scipy.linalg.eig(a, right=False)
    assert np.sum(np.abs(w.imag) > 1e-9) == 2 * n_rot
    w_real = np.sort(w[np.abs(w.imag) < 1e-9].real)

    aj = jnp.asarray(a)
    opts = SolverOptions(n_targ=4, n_max=6, max_iter=300, tol=1e-8,
                         max_dav=10)
    res = nonsym(dense_matvec(aj), dense_matvec(aj.T),
                 diag_precnd(jnp.diagonal(aj)),
                 jnp.zeros((6, a.shape[0])), opts, side="r",
                 key=jax.random.PRNGKey(5))
    assert bool(res.ok)
    np.testing.assert_allclose(np.asarray(res.eig[:4]), w_real[:4],
                               rtol=0, atol=1e-7)


def test_pass_programs_released_with_operator():
    """The nonsym program memo must not pin operator closures (at flagship
    scale each closure holds a multi-GB block store): programs live ON the
    operator callable, so dropping the matvec closure releases them."""
    import gc
    import weakref

    a = nonsym_matrix(64, jax.random.PRNGKey(2), variant=3)
    mv = dense_matvec(a)
    mv_l = dense_matvec(a.T)
    pc = diag_precnd(jnp.diagonal(a))
    opts = SolverOptions(n_targ=2, n_max=2, max_iter=30, tol=1e-7,
                         max_dav=8)
    res = nonsym(mv, mv_l, pc, jnp.zeros((2, 64), jnp.float64), opts,
                 side="r", key=jax.random.PRNGKey(3), driver="host")
    assert bool(res.ok)
    assert "_nonsym_pass_programs" in mv.__dict__  # memo rides the closure
    ref = weakref.ref(mv)
    del mv, mv_l, pc, res
    gc.collect()
    assert ref() is None  # operator + its programs are collectible


def test_pass_programs_not_poisoned_by_jitted_trace():
    """A jitted (device-driver) solve must not leak its trace into the
    program memo: a later HOST-driver solve over the SAME operator
    closures previously died with UnexpectedTracerError (the memoized
    step closures captured constants lifted to tracers; bench.py
    nonsym_toy hit exactly this sequence)."""
    a = nonsym_matrix(64, jax.random.PRNGKey(2), variant=3)
    mv = dense_matvec(a)
    mv_l = dense_matvec(a.T)
    pc = diag_precnd(jnp.diagonal(a))
    opts = SolverOptions(n_targ=2, n_max=2, max_iter=40, tol=1e-7,
                         max_dav=8)
    g = jnp.zeros((2, 64), jnp.float64)

    run_dev = jax.jit(lambda g, k: nonsym(mv, mv_l, pc, g, opts, side="r",
                                          key=k, driver="device"))
    res_dev = run_dev(g, jax.random.PRNGKey(3))
    assert bool(res_dev.ok)
    # same closures, host driver, OUTSIDE jit: must not see dev tracers
    res_host = nonsym(mv, mv_l, pc, g, opts, side="r",
                      key=jax.random.PRNGKey(3), driver="host")
    assert bool(res_host.ok)
    np.testing.assert_allclose(np.asarray(res_dev.eig[:2]),
                               np.asarray(res_host.eig[:2]), atol=1e-6)


def test_bsr_nonsym_similarity_matches_dense_oracle():
    """The flagship-scale similarity operator (variant-4 construction on
    plain BSR stores, problems.bsr_nonsym_similarity) must match its dense
    oracle at the f64 tier: R = E_- S E_+ with the same order-4 series,
    and the left operator must be R's exact transpose."""
    from diaglib_tpu.ops.bsr import bsr_diagonal, bsr_to_dense
    from diaglib_tpu.problems import (
        bsr_nonsym_similarity,
        nonsym_similarity_ops,
    )

    n, B, bpr = 192, 32, 3
    lo, hi = bsr_nonsym_similarity(n, B, bpr, jax.random.PRNGKey(5),
                                   t_scale=0.05)
    s_dense, t_dense, tt_dense = (np.asarray(bsr_to_dense(m)) for m in hi)
    # the two tiers hold the same values
    for a32, a64 in zip(lo, hi):
        assert a32.blocks_t.dtype == jnp.float32
        np.testing.assert_array_equal(np.asarray(a32.blocks_t, np.float64),
                                      np.asarray(a64.blocks_t))

    def series(m, sign, terms=4):
        acc = np.eye(n)
        term = np.eye(n)
        for j in range(1, terms + 1):
            term = term @ (sign * m) / j
            acc = acc + term
        return acc

    r_dense = series(t_dense, -1.0) @ s_dense @ series(t_dense, 1.0)

    mv, mv_l = nonsym_similarity_ops(hi)
    x = jax.random.normal(jax.random.PRNGKey(9), (4, n), jnp.float64)
    scale = np.max(np.abs(r_dense)) * float(jnp.max(jnp.abs(x)))
    np.testing.assert_allclose(np.asarray(mv(x)), np.asarray(x) @ r_dense.T,
                               atol=1e-13 * scale)
    np.testing.assert_allclose(np.asarray(mv_l(x)), np.asarray(x) @ r_dense,
                               atol=1e-13 * scale)
    np.testing.assert_allclose(np.asarray(bsr_diagonal(hi[0])),
                               np.diagonal(s_dense), atol=0)
    # transpose-store consistency (T^T really is T transposed)
    np.testing.assert_allclose(tt_dense, t_dense.T, atol=0)


def test_nonsym_solver_on_similarity_stores():
    """End-to-end: two-sided Davidson (device reduced-eig driver) on the
    BSR similarity operator recovers eigh(S) — the variant-4 spectrum
    contract at BSR scale."""
    from diaglib_tpu.ops.bsr import bsr_diagonal, bsr_to_dense
    from diaglib_tpu.problems import (
        bsr_nonsym_similarity,
        diag_precnd,
        nonsym_similarity_ops,
    )

    n, B, bpr = 192, 32, 3
    _, hi = bsr_nonsym_similarity(n, B, bpr, jax.random.PRNGKey(5),
                                  t_scale=0.05)
    w_ref = np.linalg.eigvalsh(np.asarray(bsr_to_dense(hi[0])))

    mv, mv_l = nonsym_similarity_ops(hi)
    opts = SolverOptions(n_targ=3, n_max=3, max_iter=100, tol=1e-9,
                         max_dav=10)
    res = nonsym(mv, mv_l, diag_precnd(bsr_diagonal(hi[0])),
                 jnp.zeros((3, n), jnp.float64), opts, side="c",
                 key=jax.random.PRNGKey(3), driver="device")
    assert bool(res.ok)
    np.testing.assert_allclose(np.asarray(res.eig[:3]), w_ref[:3],
                               rtol=0, atol=1e-7)


def test_pass_protocol_matches_consecutive():
    """nonsym_pass + nonsym_seed_left + nonsym_finalize reproduce
    nonsym(side='c') exactly — including with a TRACED use_left flag (the
    side-polymorphic single-program mode the flagship bench compiles)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from diaglib_tpu import SolverOptions
    from diaglib_tpu.problems import dense_matvec, diag_precnd, nonsym_matrix
    from diaglib_tpu.solvers import (
        nonsym,
        nonsym_finalize,
        nonsym_pass,
        nonsym_seed_left,
    )
    from diaglib_tpu.utils.guess import guess_evec

    n, n_want = 200, 4
    a = nonsym_matrix(n, jax.random.PRNGKey(1), variant=4)
    dn = jnp.diagonal(a)
    g = guess_evec(6, jax.random.PRNGKey(1), n, n_want, diagonal=dn)
    opts = SolverOptions(n_targ=n_want, n_max=n_want, max_iter=100, tol=1e-9,
                         max_dav=10)
    mv, mvl, pc = dense_matvec(a), dense_matvec(a.T), diag_precnd(dn)
    key = jax.random.PRNGKey(7)
    kr, kl = jax.random.split(key)

    ref = nonsym(mv, mvl, pc, g, opts, side="c", key=key, driver="device")

    # static per-pass protocol
    r = nonsym_pass(mv, pc, g, opts, use_left=False, key=kr, driver="device")
    gl, seed_ok = nonsym_seed_left(r.evec)
    l = nonsym_pass(mvl, pc, gl, opts, use_left=True, key=kl,
                    driver="device")
    out = nonsym_finalize(r, l, opts, seed_ok=seed_ok)
    assert bool(out.ok) and bool(ref.ok)
    np.testing.assert_allclose(np.asarray(out.eig[:n_want]),
                               np.asarray(ref.eig[:n_want]), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(out.evec_r),
                               np.asarray(ref.evec_r), atol=1e-10)

    # side-polymorphic: ONE jitted pass program, use_left as a traced flag
    @jax.jit
    def poly_pass(amat, use_left, g, k):
        op = dense_matvec(amat)
        return nonsym_pass(op, pc, g, opts, use_left=use_left, key=k,
                           driver="device")

    r2 = poly_pass(a, jnp.asarray(False), g, kr)
    gl2, seed_ok2 = nonsym_seed_left(r2.evec)
    l2 = poly_pass(a.T, jnp.asarray(True), gl2, kl)
    out2 = nonsym_finalize(r2, l2, opts, seed_ok=seed_ok2)
    assert bool(out2.ok)
    np.testing.assert_allclose(np.asarray(out2.eig[:n_want]),
                               np.asarray(ref.eig[:n_want]), rtol=1e-10)
    # the traced-flag program is ONE compilation serving both sides
    np.testing.assert_allclose(np.asarray(r2.eig[:n_want]),
                               np.asarray(r.eig[:n_want]), rtol=1e-12)


def test_similarity_sided_matches_two_closure_ops():
    """nonsym_similarity_sided(stores, sign=+1/-1) reproduces the
    (mv, mv_l) pair of nonsym_similarity_ops exactly, also with a TRACED
    sign — the contract the side-polymorphic flagship pass program relies
    on — at both tiers."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from diaglib_tpu.problems import (
        bsr_nonsym_similarity,
        nonsym_similarity_ops,
        nonsym_similarity_sided,
    )

    n, B, bpr = 1024, 128, 3
    for stores in bsr_nonsym_similarity(n, B, bpr, jax.random.PRNGKey(0)):
        s_store, st, stt = stores
        dtype = s_store.blocks_t.dtype
        x = jax.random.normal(jax.random.PRNGKey(1), (4, n), dtype)

        mv, mv_l = nonsym_similarity_ops(stores)
        sided = jax.jit(lambda s_, t_, sign, x: nonsym_similarity_sided(
            s_, t_, sign)(x))
        one = jnp.asarray(1.0, dtype)
        np.testing.assert_array_equal(np.asarray(sided(s_store, st, one, x)),
                                      np.asarray(jax.jit(mv)(x)))
        np.testing.assert_array_equal(
            np.asarray(sided(s_store, stt, -one, x)),
            np.asarray(jax.jit(mv_l)(x)))
        # the transpose relation: <y, R x> == <R^T y, x>
        y = jax.random.normal(jax.random.PRNGKey(2), (4, n), dtype)
        lhs = float(jnp.sum(y * mv(x)))
        rhs = float(jnp.sum(mv_l(y) * x))
        tol = 1e-8 if dtype == jnp.float64 else 1e-3
        assert abs(lhs - rhs) < tol * max(abs(lhs), 1.0)
