"""Eigenvector guess generation and validation.

Ports the semantics of the reference's ``check_guess`` (diaglib.f90:3734-3786)
and the test driver's ``guess_evec`` strategies 1-6 (main.f90:1312-1397) to
jax.random.  Exact Fortran RNG streams are not reproducible; determinism comes
from the caller-supplied PRNG key instead.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .mm import mmT

__all__ = ["guess_evec", "check_guess"]


def _ortho_cd(*args, **kwargs):
    # imported lazily: ortho.core depends on utils.masking, so a top-level
    # import here would be circular through the package __init__s.
    from ..ortho.core import ortho_cd

    return ortho_cd(*args, **kwargs)


def guess_evec(strategy: int, key, n: int, m: int, diagonal=None, dtype=jnp.float64):
    """Build an (m, n) guess block (rows are vectors).

    Strategies (main.f90:1337-1395):
      1: unit vectors at the m smallest diagonal entries
      2: unit vectors at the m largest diagonal entries
      3: uniform random in [0, 1)
      4: uniform random in [-0.5, 0.5)
      5: 0.01*random + unit vectors at the m largest diagonal entries
      6: 0.01*random + unit vectors at the m smallest diagonal entries
    """
    if strategy in (1, 2, 5, 6):
        if diagonal is None:
            raise ValueError("diagonal required for strategies 1/2/5/6")
        diagonal = jnp.asarray(diagonal, dtype)
        order = jnp.argsort(diagonal if strategy in (1, 6) else -diagonal)
        pos = order[:m]
        onehots = jax.nn.one_hot(pos, n, dtype=dtype)
        if strategy in (1, 2):
            return onehots
        noise = 0.01 * jax.random.uniform(key, (m, n), dtype=dtype)
        return noise + onehots
    if strategy == 3:
        return jax.random.uniform(key, (m, n), dtype=dtype)
    if strategy == 4:
        return jax.random.uniform(key, (m, n), dtype=dtype) - 0.5
    raise ValueError(f"unknown guess strategy {strategy}")


def check_guess(evec, key, mask=None):
    """Validate/repair a guess block (diaglib.f90:3734-3786).

    If ``evec`` is identically zero, generate a random guess and ortho_cd it.
    Otherwise check orthonormality of the valid rows via the overlap's
    diagonal/off-diagonal norms and re-orthonormalize when needed (the
    reference uses exact floating comparisons ``diag_norm .ne. one``,
    diaglib.f90:3774 — reproduced here).
    """
    m, n = evec.shape
    if mask is None:
        mask = jnp.ones((m,), dtype=bool)
    mvalid = jnp.sum(mask)

    fac = jnp.sqrt(jnp.sum(jnp.where(mask[:, None], evec, 0.0) ** 2))

    # branch-free compute-and-select: selecting the candidate first needs
    # only one ortho_cd (a lax.cond would hold one per branch), with
    # identical results.
    rnd = jax.random.uniform(key, evec.shape, dtype=evec.dtype)
    e = jnp.where(fac == 0.0, rnd, evec)
    e = jnp.where(mask[:, None], e, 0.0)

    overlap = mmT(e, e)
    diag = jnp.diagonal(overlap)
    diag_norm = jnp.sum(jnp.where(mask, diag, 0.0) ** 2) / jnp.maximum(mvalid, 1)
    outer = mask[:, None] & mask[None, :]
    strict = jnp.triu(jnp.where(outer, overlap, 0.0), k=1)
    out_norm = jnp.sum(strict**2)
    needs = (fac == 0.0) | (diag_norm != 1.0) | (out_norm != 0.0)

    reorth, _, _ = _ortho_cd(e, mask)
    return jnp.where(needs, reorth, e)
