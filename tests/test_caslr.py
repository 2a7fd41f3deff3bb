"""Casida linear-response solver tests vs the dense pencil oracle.

Protocol of test_caslr/test_scflr (main.f90:528-908): the full matrices are
E = [[A,B],[B,A]], S = [[Sig,Del],[-Del,-Sig]]; the dense oracle solves
S x = e E x and reads the excitation energies as w = 1/e from the top
(main.f90:616-629).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg

from diaglib_tpu import SolverOptions
from diaglib_tpu.problems import (
    casida_blocks,
    dense_matvec,
    lrprec_eff,
    lrprec_std,
)
from diaglib_tpu.solvers import caslr, caslr_eff
from diaglib_tpu.utils.guess import guess_evec

N = 150
N_WANT = 5
N_EIG = min(2 * N_WANT, N_WANT + 5)
TOL = 1e-8


def _setup(tdscf):
    blk = casida_blocks(N, jax.random.PRNGKey(17), tdscf=tdscf)
    e_full = np.block([[np.asarray(blk["aa"]), np.asarray(blk["bb"])],
                       [np.asarray(blk["bb"]), np.asarray(blk["aa"])]])
    s_full = np.block(
        [[np.asarray(blk["sigma"]), np.asarray(blk["delta"])],
         [-np.asarray(blk["delta"]), -np.asarray(blk["sigma"])]])
    e_vals, e_vecs = scipy.linalg.eigh(s_full, e_full)
    omega = 1.0 / e_vals[::-1][:N_EIG]
    xs = e_vecs[:, ::-1][:, :N_EIG]
    diag = jnp.diagonal(blk["aa"]) - jnp.diagonal(blk["sigma"])
    guess = guess_evec(4, jax.random.PRNGKey(3), 2 * N, N_EIG, diagonal=diag)
    ops = dict(
        apbmul=dense_matvec(blk["apb"]),
        ambmul=dense_matvec(blk["amb"]),
        spdmul=dense_matvec(blk["spd"]),
        smdmul=dense_matvec(blk["smd"]),
    )
    pc_std = lrprec_std(jnp.diagonal(blk["aa"]), jnp.diagonal(blk["sigma"]))
    pc_eff = lrprec_eff(jnp.diagonal(blk["aa"]), jnp.diagonal(blk["sigma"]))
    return blk, ops, pc_std, pc_eff, guess, omega, xs


@pytest.fixture(scope="module")
def casida():
    return _setup(tdscf=False)


@pytest.fixture(scope="module")
def tdscf():
    return _setup(tdscf=True)


def _check_vectors(res, omega, xs, n_check):
    """Eigenvectors match up to scale/phase (conventions differ)."""
    for i in range(n_check):
        v = np.asarray(res.evec[i])
        v = v / np.linalg.norm(v)
        u = xs[:, i] / np.linalg.norm(xs[:, i])
        assert abs(float(v @ u)) > 1 - 1e-6, f"root {i}"


def test_caslr_inverse_pencil(casida):
    _, ops, pc_std, _, guess, omega, xs = casida
    opts = SolverOptions(n_targ=N_WANT, n_max=N_EIG, max_iter=100, tol=TOL,
                         max_dav=10)
    res = caslr(lrprec=pc_std, evec_guess=guess, options=opts, algorithm=0,
                **ops)
    assert bool(res.ok)
    np.testing.assert_allclose(np.asarray(res.eig[:N_WANT]), omega[:N_WANT],
                               rtol=1e-9)
    _check_vectors(res, omega, xs, N_WANT)


def test_caslr_helmich_paris(casida):
    _, ops, pc_std, _, guess, omega, xs = casida
    opts = SolverOptions(n_targ=N_WANT, n_max=N_EIG, max_iter=100, tol=TOL,
                         max_dav=10)
    res = caslr(lrprec=pc_std, evec_guess=guess, options=opts, algorithm=1,
                **ops)
    assert bool(res.ok)
    np.testing.assert_allclose(np.asarray(res.eig[:N_WANT]), omega[:N_WANT],
                               rtol=1e-9)
    _check_vectors(res, omega, xs, N_WANT)


def test_caslr_eff(casida):
    _, ops, _, pc_eff, guess, omega, xs = casida
    opts = SolverOptions(n_targ=N_WANT, n_max=N_EIG, max_iter=100, tol=TOL,
                         max_dav=10)
    res = caslr_eff(lrprec=pc_eff, evec_guess=guess, options=opts, **ops)
    assert bool(res.ok)
    np.testing.assert_allclose(np.asarray(res.eig[:N_WANT]), omega[:N_WANT],
                               rtol=1e-9)
    _check_vectors(res, omega, xs, N_WANT)


def test_caslr_tdscf(tdscf):
    """TD-SCF shortcut: sigma = I, delta = 0 (test_scflr, main.f90:732-908)."""
    _, ops, pc_std, pc_eff, guess, omega, xs = tdscf
    opts = SolverOptions(n_targ=N_WANT, n_max=N_EIG, max_iter=100, tol=TOL,
                         max_dav=10)
    res = caslr(lrprec=pc_std, evec_guess=guess, options=opts, **ops)
    assert bool(res.ok)
    np.testing.assert_allclose(np.asarray(res.eig[:N_WANT]), omega[:N_WANT],
                               rtol=1e-9)
    res2 = caslr_eff(lrprec=pc_eff, evec_guess=guess, options=opts, **ops)
    assert bool(res2.ok)
    np.testing.assert_allclose(np.asarray(res2.eig[:N_WANT]), omega[:N_WANT],
                               rtol=1e-9)


def test_caslr_agreement_between_algorithms(casida):
    """All three paths must agree with each other (caslr.txt vs cashp.txt
    vs caslr_eff.txt in the reference protocol)."""
    _, ops, pc_std, pc_eff, guess, _, _ = casida
    opts = SolverOptions(n_targ=N_WANT, n_max=N_EIG, max_iter=100, tol=TOL,
                         max_dav=10)
    e0 = caslr(lrprec=pc_std, evec_guess=guess, options=opts, algorithm=0,
               **ops).eig[:N_WANT]
    e1 = caslr(lrprec=pc_std, evec_guess=guess, options=opts, algorithm=1,
               **ops).eig[:N_WANT]
    e2 = caslr_eff(lrprec=pc_eff, evec_guess=guess, options=opts,
                   **ops).eig[:N_WANT]
    np.testing.assert_allclose(np.asarray(e0), np.asarray(e1), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(e0), np.asarray(e2), rtol=1e-9)


def test_caslr_half_zero_guess_repaired_per_row(casida):
    """A guess with SOME zero rows (vectors) must be repaired row-wise —
    check_guess contract (diaglib.f90:3734-3786) extended to the LR
    drivers; a block-granular check would feed a rank-deficient block
    into ortho_cd."""
    _, ops, pc_std, pc_eff, guess, omega, xs = casida
    half = guess.at[N_EIG // 2:].set(0.0)  # zero out half the guess vectors
    opts = SolverOptions(n_targ=N_WANT, n_max=N_EIG, max_iter=100, tol=TOL,
                         max_dav=10)
    res = caslr(lrprec=pc_std, evec_guess=half, options=opts,
                key=jax.random.PRNGKey(5), **ops)
    assert bool(res.ok) and bool(res.ortho_ok)
    np.testing.assert_allclose(np.asarray(res.eig[:N_WANT]), omega[:N_WANT],
                               rtol=1e-9)
    res_eff = caslr_eff(lrprec=pc_eff, evec_guess=half, options=opts,
                        key=jax.random.PRNGKey(5), **ops)
    assert bool(res_eff.ok)
    np.testing.assert_allclose(np.asarray(res_eff.eig[:N_WANT]),
                               omega[:N_WANT], rtol=1e-9)


def test_hp_masked_svd_matches_masked_svd():
    """The HP path's two-sided SVD reroute (see caslr._hp_masked_svd)
    keeps masked_svd's exact contract."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from diaglib_tpu.solvers.caslr import _hp_masked_svd
    from diaglib_tpu.utils.masking import masked_svd

    key = jax.random.PRNGKey(3)
    a = jax.random.normal(key, (12, 12), jnp.float64)
    mask = jnp.arange(12) < 9
    u1, s1, vt1 = masked_svd(a, mask, "device")
    u2, s2, vt2 = _hp_masked_svd(a, mask, "jacobi", 0.0)
    np.testing.assert_allclose(np.asarray(s2[:9]), np.asarray(s1[:9]),
                               rtol=1e-12)
    # same subspaces (signs/rotations within degenerate clusters may vary):
    # compare the reconstructed masked matrix
    rec = (u2[:, :9] * s2[:9][None, :]) @ vt2[:9, :]
    av = np.where(np.asarray(mask[:, None] & mask[None, :]), np.asarray(a), 0.0)
    np.testing.assert_allclose(np.asarray(rec), av, atol=1e-12)
