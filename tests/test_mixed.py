"""Mixed-precision solve ladder (solvers/mixed.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diaglib_tpu import SolverOptions
from diaglib_tpu.ops import bsr_diagonal, bsr_matvec, bsr_to_dense, random_bsr_spd
from diaglib_tpu.problems import diag_precnd
from diaglib_tpu.solvers import davidson, davidson_ladder, lobpcg_ladder

N, B = 512, 32
OPTS = SolverOptions(n_targ=4, n_max=8, max_iter=150, tol=1e-10)


def _problem():
    m64 = random_bsr_spd(N, B, 4, jax.random.PRNGKey(11), dtype=jnp.float64)
    m32 = dataclasses.replace(m64, blocks_t=m64.blocks_t.astype(jnp.float32))
    d = bsr_diagonal(m64)
    lo = (bsr_matvec(m32), diag_precnd(d.astype(jnp.float32)))
    hi = (bsr_matvec(m64), diag_precnd(d))
    return m64, lo, hi


def test_davidson_ladder_full_f64_accuracy():
    m64, (mv32, pc32), (mv64, pc64) = _problem()
    res = davidson_ladder(mv32, pc32, mv64, pc64, jnp.zeros((8, N)), OPTS,
                          key=jax.random.PRNGKey(1))
    assert bool(res.ok)
    assert res.eig.dtype == jnp.float64
    w = jnp.linalg.eigh(bsr_to_dense(m64))[0]
    np.testing.assert_allclose(np.asarray(res.eig[:4]), np.asarray(w[:4]),
                               rtol=0, atol=1e-9)


def test_ladder_cuts_f64_iterations():
    m64, (mv32, pc32), (mv64, pc64) = _problem()
    direct = davidson(mv64, pc64, jnp.zeros((8, N)), OPTS,
                      key=jax.random.PRNGKey(1))
    ladder = davidson_ladder(mv32, pc32, mv64, pc64, jnp.zeros((8, N)), OPTS,
                             key=jax.random.PRNGKey(1))
    assert bool(direct.ok) and bool(ladder.ok)
    # histories cover only the f64 stage: its iteration count is the number
    # of non-inf rms rows, and warm starting must cut it well below direct
    f64_iters = int(jnp.sum(jnp.isfinite(ladder.rms_history[:, 0])))
    assert f64_iters < int(direct.n_iter) // 2, (f64_iters, int(direct.n_iter))


def test_lobpcg_ladder():
    m64, (mv32, pc32), (mv64, pc64) = _problem()
    opts = dataclasses.replace(OPTS, tol=1e-9, max_iter=300)
    res = lobpcg_ladder(mv32, pc32, mv64, pc64, jnp.zeros((8, N)), opts,
                        key=jax.random.PRNGKey(2))
    assert bool(res.ok)
    w = jnp.linalg.eigh(bsr_to_dense(m64))[0]
    np.testing.assert_allclose(np.asarray(res.eig[:4]), np.asarray(w[:4]),
                               rtol=0, atol=1e-8)


def _spd_pair(key, scale=1.0):
    """Small dense SPD matrix pair for the LR/generalized ladders."""
    n = 150
    i = jnp.arange(1, n + 1, dtype=jnp.float64)
    apb = 0.2 / (i[:, None] + i[None, :])
    apb = jnp.fill_diagonal(apb, 5.0 + i, inplace=False)
    amb = jnp.diag(2.0 + i)
    return apb, amb


def test_gen_david_ladder():
    from diaglib_tpu.problems import dense_matvec, metric_matrix, symm_matrix
    from diaglib_tpu.solvers import gen_david_ladder
    import scipy.linalg

    n = 200
    a = symm_matrix(n)
    s = metric_matrix(n, jax.random.PRNGKey(5))
    opts = SolverOptions(n_targ=4, n_max=8, max_iter=150, tol=1e-10)
    a32, s32 = a.astype(jnp.float32), s.astype(jnp.float32)
    res = gen_david_ladder(
        dense_matvec(a32), diag_precnd(jnp.diagonal(a32)), dense_matvec(s32),
        dense_matvec(a), diag_precnd(jnp.diagonal(a)), dense_matvec(s),
        jnp.zeros((8, n)), opts, key=jax.random.PRNGKey(1))
    assert bool(res.ok)
    w = scipy.linalg.eigh(np.asarray(a), np.asarray(s), eigvals_only=True)
    np.testing.assert_allclose(np.asarray(res.eig[:4]), w[:4], rtol=0,
                               atol=1e-9)


def _lr_setup():
    import scipy.linalg

    from diaglib_tpu.problems import (casida_blocks, dense_matvec,
                                      lrprec_eff, lrprec_std)
    from diaglib_tpu.solvers.mixed import LROps

    n = 150
    blk = casida_blocks(n, jax.random.PRNGKey(17))
    e_full = np.block([[np.asarray(blk["aa"]), np.asarray(blk["bb"])],
                       [np.asarray(blk["bb"]), np.asarray(blk["aa"])]])
    s_full = np.block(
        [[np.asarray(blk["sigma"]), np.asarray(blk["delta"])],
         [-np.asarray(blk["delta"]), -np.asarray(blk["sigma"])]])
    ev = scipy.linalg.eigh(s_full, e_full, eigvals_only=True)
    omega = 1.0 / ev[::-1][:8]
    a_d, s_d = jnp.diagonal(blk["aa"]), jnp.diagonal(blk["sigma"])

    def ops(dtype, lrprec):
        return LROps(
            apbmul=dense_matvec(blk["apb"].astype(dtype)),
            ambmul=dense_matvec(blk["amb"].astype(dtype)),
            spdmul=dense_matvec(blk["spd"].astype(dtype)),
            smdmul=dense_matvec(blk["smd"].astype(dtype)),
            lrprec=lrprec,
        )

    pc_std32 = lrprec_std(a_d.astype(jnp.float32), s_d.astype(jnp.float32))
    pc_eff32 = lrprec_eff(a_d.astype(jnp.float32), s_d.astype(jnp.float32))
    return (n, omega,
            ops(jnp.float32, pc_std32), ops(jnp.float64, lrprec_std(a_d, s_d)),
            ops(jnp.float32, pc_eff32), ops(jnp.float64, lrprec_eff(a_d, s_d)))


def test_caslr_ladder():
    from diaglib_tpu.solvers import caslr_ladder

    n, omega, lo_std, hi_std, _, _ = _lr_setup()
    opts = SolverOptions(n_targ=4, n_max=8, max_iter=150, tol=1e-10,
                         max_dav=10)
    res = caslr_ladder(lo_std, hi_std, jnp.zeros((8, 2 * n)), opts,
                       key=jax.random.PRNGKey(1))
    assert bool(res.ok)
    np.testing.assert_allclose(np.asarray(res.eig[:4]), omega[:4], rtol=1e-9)


def test_caslr_eff_ladder():
    from diaglib_tpu.solvers import caslr_eff_ladder

    n, omega, _, _, lo_eff, hi_eff = _lr_setup()
    opts = SolverOptions(n_targ=4, n_max=8, max_iter=150, tol=1e-10,
                         max_dav=10)
    res = caslr_eff_ladder(lo_eff, hi_eff, jnp.zeros((8, 2 * n)), opts,
                           key=jax.random.PRNGKey(1))
    assert bool(res.ok)
    np.testing.assert_allclose(np.asarray(res.eig[:4]), omega[:4], rtol=1e-9)


@pytest.mark.parametrize("driver", ["auto", "device"])
def test_nonsym_ladder(driver):
    """Both reduced-eig drivers must be honored by BOTH ladder stages
    (the driver kwarg is forwarded to the f32 and f64 passes)."""
    import scipy.linalg

    from diaglib_tpu.problems import dense_matvec, nonsym_matrix
    from diaglib_tpu.solvers import nonsym_ladder
    from diaglib_tpu.utils.guess import guess_evec

    n = 200
    a = nonsym_matrix(n, jax.random.PRNGKey(1), variant=4)
    a32 = a.astype(jnp.float32)
    diag = jnp.diagonal(a)
    w = np.sort(scipy.linalg.eig(np.asarray(a), right=False).real)
    opts = SolverOptions(n_targ=4, n_max=4, max_iter=100, tol=1e-10,
                         max_dav=10)
    guess = guess_evec(6, jax.random.PRNGKey(1), n, 4, diagonal=diag)
    res = nonsym_ladder(
        dense_matvec(a32), dense_matvec(a32.T),
        diag_precnd(diag.astype(jnp.float32)),
        dense_matvec(a), dense_matvec(a.T), diag_precnd(diag),
        guess, opts, side="c", key=jax.random.PRNGKey(1), lo_tol=1e-5,
        driver=driver)
    assert bool(res.ok)
    np.testing.assert_allclose(np.asarray(res.eig[:4]), w[:4], rtol=0,
                               atol=1e-8)


def test_caslr_eff_ladder_sliced_bsr():
    """Flagship-path shape at test scale: the mixed-precision LR ladder on
    plain BSR (A+B)/(A-B) stores at both tiers (tdscf structure),
    eigenvalues vs the dense pencil oracle."""
    import scipy.linalg

    from diaglib_tpu.ops.bsr import bsr_to_dense
    from diaglib_tpu.problems import bsr_casida_tdscf, casida_tdscf_ops
    from diaglib_tpu.solvers import caslr_eff_ladder

    n = 256
    lo, hi = bsr_casida_tdscf(n, 8, 2, jax.random.PRNGKey(3))
    # dense oracle: E = [[A,B],[B,A]], S = [[I,0],[0,-I]], w = 1/e desc
    apb, amb = (np.asarray(bsr_to_dense(m)) for m in hi)
    aa, bb = 0.5 * (apb + amb), 0.5 * (apb - amb)
    e_full = np.block([[aa, bb], [bb, aa]])
    s_full = np.block([[np.eye(n), np.zeros((n, n))],
                       [np.zeros((n, n)), -np.eye(n)]])
    ev = scipy.linalg.eigh(s_full, e_full, eigvals_only=True)
    omega = 1.0 / ev[::-1][:4]

    opts = SolverOptions(n_targ=2, n_max=4, max_iter=150, tol=1e-10,
                         max_dav=10)
    res = jax.jit(lambda lo, hi, g, k: caslr_eff_ladder(
        casida_tdscf_ops(*lo), casida_tdscf_ops(*hi), g, opts, key=k))(
            lo, hi, jnp.zeros((4, 2 * n)), jax.random.PRNGKey(1))
    assert bool(res.ok)
    np.testing.assert_allclose(np.asarray(res.eig[:2]), omega[:2], rtol=1e-8)
