"""Mesh and sharding helpers for row-vector blocks.

Design (SURVEY.md §5 "distributed communication backend"): one mesh axis
``"n"`` spanning the devices; every O(n) array is sharded along its last
axis with ``P(None, "n")`` (vectors are rows, the long axis lives in lanes);
reduced matrices (ldu x ldu) are replicated.  Under ``jit``, annotating the
solver's initial state with these shardings makes XLA insert the
all-reduces for every Gram contraction ``x @ y.T`` automatically — the
equivalent of the reference linking a parallel BLAS.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "VectorSharding"]


def make_mesh(devices=None, axis_name: str = "n") -> Mesh:
    """1-D device mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.array(devices), (axis_name,))


@dataclasses.dataclass(frozen=True)
class VectorSharding:
    """Sharding policy for the solvers.

    vec(x):   constrain a (..., n) block to be sharded along n.
    rep(x):   constrain an array to be fully replicated.

    Pass as ``sharding=`` to any solver; pass None (default) for single
    device.  The user's matvec/precnd callbacks receive sharded blocks and
    must be sharding-polymorphic (pure jnp code is, automatically).
    """

    mesh: Mesh
    axis: str = "n"

    def spec(self, ndim: int) -> P:
        return P(*([None] * (ndim - 1) + [self.axis]))

    def vec(self, x):
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(self.mesh, self.spec(x.ndim))
        )

    def rep(self, x):
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(self.mesh, P())
        )


def constrainers(sharding: Optional[VectorSharding]):
    """(vec, rep) constraint functions, identity when sharding is None."""
    if sharding is None:
        ident = lambda x: x  # noqa: E731
        return ident, ident
    return sharding.vec, sharding.rep
