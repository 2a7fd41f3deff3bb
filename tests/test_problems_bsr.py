"""The flagship-scale problem builders on plain BSR stores, at CPU size:
each builder against a dense oracle at both precision tiers, and each
driver's mixed-precision ladder on them against a dense solve."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg

from diaglib_tpu import SolverOptions
from diaglib_tpu.ops import (
    bsr_astype,
    bsr_diagonal,
    bsr_matvec,
    bsr_to_dense,
    random_bsr_spd,
)
from diaglib_tpu.problems import (
    bsr_casida_tdscf,
    bsr_gen_problem,
    bsr_nonsym_similarity,
    casida_tdscf_ops,
    diag_precnd,
    nonsym_similarity_ops,
)

N, B, BPR = 256, 16, 3
KEY = jax.random.PRNGKey(4)


def _dense(m):
    return np.asarray(bsr_to_dense(m), np.float64)


def _series(t, sign, terms=4):
    acc = term = np.eye(t.shape[0])
    for j in range(1, terms + 1):
        term = term @ (sign * t) / j
        acc = acc + term
    return acc


def _apply_checks(builder, stores, dtype):
    """(operator closures, dense oracles) of one tier of a builder."""
    if builder == "casida":
        apb, amb = stores
        ops = casida_tdscf_ops(apb, amb)
        return ([ops.apbmul, ops.ambmul], [_dense(apb), _dense(amb)])
    if builder == "nonsym":
        s, t, _ = stores
        mv, mv_l = nonsym_similarity_ops(stores)
        r = _series(_dense(t), -1.0) @ _dense(s) @ _series(_dense(t), 1.0)
        return [mv, mv_l], [r, r.T]
    a, b = stores
    return [bsr_matvec(a), bsr_matvec(b)], [_dense(a), _dense(b)]


@pytest.mark.parametrize("tier", ["lo", "hi"])
@pytest.mark.parametrize("builder", ["casida", "nonsym", "gen"])
def test_builder_matches_dense_oracle(builder, tier):
    make = {"casida": bsr_casida_tdscf, "nonsym": bsr_nonsym_similarity,
            "gen": bsr_gen_problem}[builder]
    lo, hi = make(N, B, BPR, KEY)
    stores = lo if tier == "lo" else hi
    dtype = jnp.float32 if tier == "lo" else jnp.float64
    for m32, m in zip(lo, stores):
        assert m.blocks_t.dtype == dtype
        # both tiers hold the same (f32-generated) values
        np.testing.assert_array_equal(np.asarray(m.blocks_t, np.float64),
                                      np.asarray(m32.blocks_t, np.float64))
    closures, oracles = _apply_checks(builder, stores, dtype)
    x = jax.random.normal(jax.random.PRNGKey(1), (5, N), dtype)
    xd = np.asarray(x, np.float64)
    tol = 1e-12 if dtype == jnp.float64 else 1e-5
    for mv, dense in zip(closures, oracles):
        y = mv(x)
        assert y.dtype == dtype
        ref = xd @ dense.T
        np.testing.assert_allclose(np.asarray(y, np.float64), ref,
                                   atol=tol * np.max(np.abs(ref)))
    if builder == "gen":  # the metric is SPD
        assert np.linalg.eigvalsh(oracles[1])[0] > 0.0


def _spd_tiers():
    m32 = random_bsr_spd(N, B, BPR, KEY, dtype=jnp.float32)
    return m32, bsr_astype(m32, jnp.float64)


def _tier(m):
    return bsr_matvec(m), diag_precnd(bsr_diagonal(m))


def _lr_oracle(hi):
    apb, amb = (_dense(m) for m in hi)
    aa, bb = 0.5 * (apb + amb), 0.5 * (apb - amb)
    e_full = np.block([[aa, bb], [bb, aa]])
    s_full = np.block([[np.eye(N), np.zeros((N, N))],
                       [np.zeros((N, N)), -np.eye(N)]])
    return 1.0 / scipy.linalg.eigh(s_full, e_full, eigvals_only=True)[::-1]


@pytest.mark.parametrize("driver", ["davidson", "lobpcg", "gen_david",
                                    "caslr", "caslr_eff", "nonsym"])
def test_ladder_on_bsr_builders(driver):
    """Each driver's mixed-precision ladder, jitted with the stores as
    arguments (as the benchmark runs them), converges to the dense
    oracle's eigenvalues."""
    from diaglib_tpu import solvers

    n_want, n_eig = 3, 6
    opts = SolverOptions(n_targ=n_want, n_max=n_eig, max_iter=150,
                         tol=1e-10, max_dav=10)
    key = jax.random.PRNGKey(1)
    if driver in ("davidson", "lobpcg"):
        lo, hi = _spd_tiers()
        ladder = getattr(solvers, f"{driver}_ladder")
        run = jax.jit(lambda lo, hi, g, k: ladder(
            *_tier(lo), *_tier(hi), g, opts, key=k,
            lo_iter=70 if driver == "lobpcg" else None))
        res = run(lo, hi, jnp.zeros((n_eig, N)), key)
        oracle = np.linalg.eigvalsh(_dense(hi))
    elif driver == "gen_david":
        lo, hi = bsr_gen_problem(N, B, BPR, KEY)
        run = jax.jit(lambda lo, hi, g, k: solvers.gen_david_ladder(
            *_tier(lo[0]), bsr_matvec(lo[1]), *_tier(hi[0]),
            bsr_matvec(hi[1]), g, opts, key=k))
        res = run(lo, hi, jnp.zeros((n_eig, N)), key)
        oracle = scipy.linalg.eigh(_dense(hi[0]), _dense(hi[1]),
                                   eigvals_only=True)
    elif driver in ("caslr", "caslr_eff"):
        lo, hi = bsr_casida_tdscf(N, B, BPR, KEY)
        prec = "std" if driver == "caslr" else "eff"
        ladder = getattr(solvers, f"{driver}_ladder")
        run = jax.jit(lambda lo, hi, g, k: ladder(
            casida_tdscf_ops(*lo, prec=prec), casida_tdscf_ops(*hi, prec=prec),
            g, opts, key=k))
        res = run(lo, hi, jnp.zeros((n_eig, 2 * N)), key)
        oracle = _lr_oracle(hi)
    else:
        lo, hi = bsr_nonsym_similarity(N, B, BPR, KEY)
        opts = SolverOptions(n_targ=n_want, n_max=n_want, max_iter=150,
                             tol=1e-10, max_dav=10)

        def run(lo, hi, g, k):
            return solvers.nonsym_ladder(
                *nonsym_similarity_ops(lo), diag_precnd(bsr_diagonal(lo[0])),
                *nonsym_similarity_ops(hi), diag_precnd(bsr_diagonal(hi[0])),
                g, opts, side="c", key=k, lo_tol=1e-5, driver="device")

        res = jax.jit(run)(lo, hi, jnp.zeros((n_want, N)), key)
        oracle = np.linalg.eigvalsh(_dense(hi[0]))
    assert bool(res.ok)
    assert res.eig.dtype == jnp.float64
    np.testing.assert_allclose(np.asarray(res.eig[:n_want]),
                               oracle[:n_want], rtol=1e-9)
