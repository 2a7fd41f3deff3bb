"""Auxiliary subsystems (SURVEY.md §5): observability, numerical debugging,
failure propagation, checkpoint/resume contract."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diaglib_tpu import SolverOptions
from diaglib_tpu.problems import dense_matvec, diag_precnd, symm_matrix
from diaglib_tpu.reporting import convergence_table, timing_report
from diaglib_tpu.solvers import davidson

N, N_WANT, N_EIG = 200, 3, 6
OPTS = SolverOptions(n_targ=N_WANT, n_max=N_EIG, max_iter=60, tol=1e-8)


def _solve(opts=OPTS, key=1):
    a = symm_matrix(N)
    return a, davidson(dense_matvec(a), diag_precnd(jnp.diagonal(a)),
                       jnp.zeros((N_EIG, N)), opts,
                       key=jax.random.PRNGKey(key))


def test_convergence_table_renders_reference_format():
    _, res = _solve()
    txt = convergence_table(res, N_WANT, "Davidson-Liu", 1e-8)
    lines = txt.splitlines()
    assert any("iter  root" in ln for ln in lines)
    # one row per (iter, root); count data rows
    data = [ln for ln in lines if ln.strip() and ln.strip()[0].isdigit()]
    assert len(data) == int(res.n_iter) * N_WANT
    # final rows must show converged roots
    assert data[-1].rstrip().endswith("T")


def test_timing_report_smoke(capsys):
    _, res = _solve()
    timing_report("davidson", 1.23, int(res.n_iter), int(res.n_matvec))
    out = capsys.readouterr().out
    assert "davidson" in out and "operator applications" in out


def test_histories_match_final_state():
    _, res = _solve()
    it = int(res.n_iter)
    np.testing.assert_allclose(np.asarray(res.eig_history[it - 1, :N_WANT]),
                               np.asarray(res.eig[:N_WANT]), rtol=0,
                               atol=1e-12)
    assert np.all(np.isinf(np.asarray(res.rms_history[it:])))


def test_solve_clean_under_debug_nans():
    """The solver must not trip jax debug_nans on its masked/padded math
    (SURVEY §5 race-detection row: debug_nans is the numerical sanitizer)."""
    with jax.debug_nans(True):
        _, res = _solve()
    assert bool(res.ok)


def test_non_convergence_is_a_status_not_a_crash():
    opts = SolverOptions(n_targ=N_WANT, n_max=N_EIG, max_iter=3, tol=1e-14)
    _, res = _solve(opts)
    assert not bool(res.ok)
    assert int(res.n_iter) == 3


def test_checkpoint_resume_contract():
    """Snapshot = the Ritz block; resuming from it converges in a few
    iterations (the reference's warm-start contract, diaglib.f90:216-218)."""
    a, partial = _solve(SolverOptions(n_targ=N_WANT, n_max=N_EIG,
                                      max_iter=6, tol=1e-10))
    assert not bool(partial.ok)
    resumed = davidson(dense_matvec(a), diag_precnd(jnp.diagonal(a)),
                       partial.evec, OPTS, key=jax.random.PRNGKey(9))
    assert bool(resumed.ok)
    full = _solve(SolverOptions(n_targ=N_WANT, n_max=N_EIG, max_iter=100,
                                tol=1e-8))[1]
    assert int(resumed.n_iter) < int(full.n_iter)
    np.testing.assert_allclose(np.asarray(resumed.eig[:N_WANT]),
                               np.asarray(full.eig[:N_WANT]), rtol=0,
                               atol=1e-9)


def test_verbose_inflight_progress(capfd):
    """SolverOptions.verbose emits one live line per iteration via
    jax.debug.print (the reference's live table, diaglib.f90:459-464)."""
    import jax
    import jax.numpy as jnp

    from diaglib_tpu import SolverOptions
    from diaglib_tpu.problems import dense_matvec, diag_precnd, symm_matrix
    from diaglib_tpu.solvers import davidson

    a = symm_matrix(100)
    opts = SolverOptions(n_targ=2, n_max=4, max_iter=50, tol=1e-8,
                         verbose=True)
    res = davidson(dense_matvec(a), diag_precnd(jnp.diagonal(a)),
                   jnp.zeros((4, 100)), opts, key=jax.random.PRNGKey(1))
    jax.effects_barrier()
    assert bool(res.ok)
    out = capfd.readouterr().out
    lines = [l for l in out.splitlines() if l.startswith("davidson it=")]
    assert len(lines) == int(res.n_iter)


def test_checkpoint_roundtrip_and_resume(tmp_path):
    """save/load a SolverResult and warm-start a resumed solve from it
    (checkpoint/resume aux subsystem; the warm-start contract is the
    reference's own, diaglib.f90:216-218)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from diaglib_tpu import SolverOptions, checkpoint
    from diaglib_tpu.problems import dense_matvec, diag_precnd, symm_matrix
    from diaglib_tpu.solvers import davidson

    a = symm_matrix(120)
    mv, pc = dense_matvec(a), diag_precnd(jnp.diagonal(a))
    opts_partial = SolverOptions(n_targ=3, n_max=6, max_iter=4, tol=1e-10)
    part = davidson(mv, pc, jnp.zeros((6, 120)), opts_partial,
                    key=jax.random.PRNGKey(1))
    assert not bool(part.ok)  # deliberately interrupted

    ckpt = str(tmp_path / "solve_ckpt")
    checkpoint.save(ckpt, part)
    restored = checkpoint.load(ckpt, like=part)
    np.testing.assert_array_equal(np.asarray(restored.evec),
                                  np.asarray(part.evec))

    opts = SolverOptions(n_targ=3, n_max=6, max_iter=100, tol=1e-10)
    res = davidson(mv, pc, restored.evec, opts)
    assert bool(res.ok)
    w = jnp.linalg.eigh(a)[0]
    np.testing.assert_allclose(np.asarray(res.eig[:3]), np.asarray(w[:3]),
                               atol=1e-9)
    # resume must be cheaper than from scratch
    scratch = davidson(mv, pc, jnp.zeros((6, 120)), opts,
                       key=jax.random.PRNGKey(1))
    assert int(res.n_iter) < int(scratch.n_iter)


def test_verbose_degrades_on_callbackless_backend(monkeypatch, recwarn):
    """On runtimes without host callbacks, verbose=True must degrade to a one-time warning, not a run-time
    failure (round-2 VERDICT Weak #6)."""
    import warnings

    import jax
    import jax.numpy as jnp

    from diaglib_tpu import SolverOptions, reporting
    from diaglib_tpu.problems import dense_matvec, diag_precnd, symm_matrix
    from diaglib_tpu.solvers import davidson

    backend = jax.default_backend()
    monkeypatch.setitem(reporting._DEBUG_CB_SUPPORT, backend, False)
    monkeypatch.setattr(reporting, "_WARNED", set())
    a = symm_matrix(100)
    opts = SolverOptions(n_targ=2, n_max=4, max_iter=50, tol=1e-8,
                         verbose=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = davidson(dense_matvec(a), diag_precnd(jnp.diagonal(a)),
                       jnp.zeros((4, 100)), opts, key=jax.random.PRNGKey(1))
    assert bool(res.ok)
    msgs = [w for w in caught if "in-flight progress disabled" in
            str(w.message)]
    assert len(msgs) == 1  # one-time warning, solve completes


@pytest.fixture
def restore_cache_dir():
    """Put the process-wide compile-cache setting back after a test."""
    prev = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


def test_enable_persistent_cache(tmp_path, monkeypatch, restore_cache_dir):
    """enable_persistent_cache turns on JAX's persistent compilation cache
    in its one directory and returns it (README 'Compile times')."""
    from diaglib_tpu.config import enable_persistent_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    p = enable_persistent_cache()
    assert p == str(tmp_path / "cache")
    assert os.path.isdir(p)
    assert jax.config.jax_compilation_cache_dir == p


def test_cache_env_var_honoured(tmp_path, monkeypatch, restore_cache_dir):
    from diaglib_tpu.config import enable_persistent_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    assert enable_persistent_cache() == str(tmp_path / "env")
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "env")


def test_cache_default_is_fixed_repo_path(monkeypatch, restore_cache_dir):
    from diaglib_tpu import config

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert config.DEFAULT_CACHE_DIR == os.path.join(repo, ".xla_cache")
    assert config.enable_persistent_cache() == config.DEFAULT_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == config.DEFAULT_CACHE_DIR


def test_cache_no_override_when_env_set(tmp_path, monkeypatch,
                                        restore_cache_dir):
    """With the variable set, repeated calls never point the cache at the
    repo default (or anywhere but the variable's directory)."""
    from diaglib_tpu import config

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    for _ in range(2):
        config.enable_persistent_cache(min_compile_secs=5.0)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "env")
    assert not os.listdir(tmp_path / "env")  # nothing compiled in 5 s here
