"""Distributed BSR SpMM on the simulated 8-device CPU mesh.

Validates the halo-exchange operator (ops/dist_bsr.py) against the
single-device BSR matvec and the dense oracle, and checks that it (a)
actually shards the work, (b) lowers to collective-permutes, and (c) drives
a fully sharded Davidson solve to the same answer as the serial path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diaglib_tpu import SolverOptions
from diaglib_tpu.ops import (
    bsr_diagonal,
    bsr_matvec,
    bsr_to_dense,
    dist_bsr_matvec,
    distribute_bsr,
    random_bsr_spd,
)
from diaglib_tpu.parallel import VectorSharding, make_mesh
from diaglib_tpu.problems import diag_precnd
from diaglib_tpu.solvers import davidson

N, B, BPR = 512, 32, 4


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, jax.devices()
    return make_mesh()


@pytest.fixture(scope="module")
def matrix():
    return random_bsr_spd(N, B, BPR, jax.random.PRNGKey(11),
                          dtype=jnp.float64)


def test_matches_single_device_and_dense(mesh, matrix):
    sh = VectorSharding(mesh)
    dm = distribute_bsr(matrix, sh)
    x = jax.random.normal(jax.random.PRNGKey(2), (5, N), jnp.float64)
    y_dist = jax.jit(dist_bsr_matvec(dm, sh))(x)
    y_ser = bsr_matvec(matrix)(x)
    np.testing.assert_allclose(np.asarray(y_dist), np.asarray(y_ser),
                               rtol=0, atol=1e-12)
    dense = bsr_to_dense(matrix)
    np.testing.assert_allclose(np.asarray(y_dist), np.asarray(x @ dense.T),
                               rtol=0, atol=1e-10)


def test_output_sharded_and_uses_ppermute(mesh, matrix):
    sh = VectorSharding(mesh)
    dm = distribute_bsr(matrix, sh)
    # every shard of the operator lives on its own device
    for leaf in jax.tree_util.tree_leaves(dm):
        assert {s.device for s in leaf.addressable_shards} == set(
            mesh.devices.flat)
        assert {s.data.shape[0] for s in leaf.addressable_shards} == {1}
    mv = jax.jit(dist_bsr_matvec(dm, sh))
    x = jax.random.normal(jax.random.PRNGKey(3), (4, N), jnp.float64)
    y = mv(x)
    shard_shapes = {s.data.shape for s in y.addressable_shards}
    assert shard_shapes == {(4, N // 8)}, shard_shapes
    txt = mv.lower(x).compile().as_text()
    assert "collective-permute" in txt, "halo exchange must use ppermute"


def test_banded_skips_empty_ring_offsets():
    # tridiagonal-in-blocks matrix over 8 shards: only ring offsets
    # {0, 1, D-1} are populated; empty ones must not exist in the pytree
    banded = random_bsr_spd(N, B, 2, jax.random.PRNGKey(23),
                            dtype=jnp.float64)
    sh = VectorSharding(make_mesh())
    dm = distribute_bsr(banded, sh)
    assert set(dm.steps) <= {0, 1, 7}, dm.steps
    assert 0 in dm.steps
    x = jax.random.normal(jax.random.PRNGKey(6), (3, N), jnp.float64)
    np.testing.assert_allclose(
        np.asarray(jax.jit(dist_bsr_matvec(dm, sh))(x)),
        np.asarray(bsr_matvec(banded)(x)), rtol=0, atol=1e-12)


def test_single_shard_degenerates_to_serial(matrix):
    dm = distribute_bsr(matrix, VectorSharding(make_mesh(jax.devices()[:1])))
    assert dm.steps == (0,)


def test_indivisible_rows_rejected(matrix):
    with pytest.raises(ValueError):
        distribute_bsr(matrix, VectorSharding(make_mesh(jax.devices()[:5])))


def test_davidson_on_distributed_operator(mesh, matrix):
    """Full solver over the halo-exchange matvec == serial solve."""
    sh = VectorSharding(mesh)
    dm = distribute_bsr(matrix, sh)
    diag = bsr_diagonal(matrix)
    opts = SolverOptions(n_targ=4, n_max=8, max_iter=100, tol=1e-9)
    guess = jnp.zeros((8, N), jnp.float64)

    res_d = jax.jit(lambda dm, g: davidson(
        dist_bsr_matvec(dm, sh), diag_precnd(diag), g, opts,
        key=jax.random.PRNGKey(4), sharding=sh))(dm, guess)
    res_s = davidson(bsr_matvec(matrix), diag_precnd(diag), guess, opts,
                     key=jax.random.PRNGKey(4))
    assert bool(res_d.ok)
    assert int(res_d.n_iter) == int(res_s.n_iter)
    np.testing.assert_allclose(np.asarray(res_d.eig[:4]),
                               np.asarray(res_s.eig[:4]), rtol=0, atol=1e-10)
    w = jnp.linalg.eigh(bsr_to_dense(matrix))[0]
    np.testing.assert_allclose(np.asarray(res_d.eig[:4]), np.asarray(w[:4]),
                               rtol=0, atol=1e-7)
