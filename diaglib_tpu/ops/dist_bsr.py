"""Distributed BSR SpMM: row-partitioned blocks + ppermute halo exchange.

This is the north-star distributed operator from SURVEY.md §2.5: the
reference (Molecolab-Pisa/diaglib) is serial Fortran and only ever touches
the matrix through user matvec callbacks, so the *scalable* matvec is a new
component with no reference counterpart.

Design
------
The block rows of a :class:`~diaglib_tpu.ops.bsr.BSRMatrix` are partitioned
contiguously over the 1-D device mesh (same ``"n"`` axis the solvers shard
their (k, n) vector blocks along, see parallel/sharding.py).  Each device
holds its rows' entries (a contiguous slice of the row-uniform store).  An
entry A(r, c) on the device owning block-row r needs the x shard owning
block-col c, which sits ``s = (shard(c) - shard(r)) mod D`` hops up the
ring:

* ``s = 0``: the device's own x shard; for banded operators this holds
  nearly all entries.
* ``s != 0``: halo shards — each fetched with ONE ``lax.ppermute`` per
  *nonempty* offset (empty offsets are skipped at trace time: a banded
  operator with bandwidth < n/D issues exactly two small permutes, to its
  ring neighbours, regardless of D).  On GPUs the permutes run over NCCL.

The fetched shards are concatenated into one local x buffer, each entry's
column index is remapped into that buffer on the host, and the local
compute is the row-uniform SpMM core of the single-device operator
(ops/bsr.py).  :func:`distribute_bsr` places each device's data on that
device; pass the result to the jitted solve as an argument.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from .bsr import BSRMatrix, _row_spmm

__all__ = ["DistBSRMatrix", "distribute_bsr", "dist_bsr_matvec"]


def _ring_layout(cols, nbr_loc: int, D: int, L: int):
    """Host-side (numpy) pattern reorganization.

    Returns ``(steps, loc)``: the sorted nonempty ring offsets, and per
    device the (nbr_loc, L) index of each entry's x block in that device's
    halo buffer (the concatenation of the x shards of ``steps``, in order).
    """
    cols = np.asarray(cols).reshape(D, nbr_loc, L)
    s_of = (cols // nbr_loc - np.arange(D)[:, None, None]) % D
    steps = tuple(sorted(set(s_of.ravel().tolist())))
    loc = np.searchsorted(steps, s_of) * nbr_loc + cols % nbr_loc
    return steps, loc.astype(np.int32)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DistBSRMatrix:
    """BSR matrix partitioned by block row over a D-device mesh axis.

    blocks_t: (D, nbr_loc * L, B, B) pre-transposed blocks of each
              device's rows (sharded over the mesh on the leading axis);
    loc_cols: (D, nbr_loc, L) int32 index of each entry's x block in the
              device's halo buffer (see :func:`_ring_layout`);
    steps:    the nonempty ring offsets whose x shards the buffer holds.
    """

    blocks_t: jax.Array
    loc_cols: jax.Array
    steps: tuple = dataclasses.field(metadata=dict(static=True))
    n: int = dataclasses.field(metadata=dict(static=True))
    block: int = dataclasses.field(metadata=dict(static=True))
    ndev: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n_local(self) -> int:
        return self.n // self.ndev


def distribute_bsr(m: BSRMatrix, sharding) -> DistBSRMatrix:
    """Partition a BSRMatrix's block rows over the devices of a mesh axis.

    ``sharding`` is the :class:`~diaglib_tpu.parallel.VectorSharding` the
    solve will use.  The sparsity pattern is reorganized on the host (index
    arrays only); every leaf is placed with its leading (device) axis
    sharded over the mesh, so each device holds only its own rows.
    Requires the block-row count to divide evenly (pad the operator if it
    does not).
    """
    B = m.block
    nbr = m.n // B
    D = sharding.mesh.shape[sharding.axis]
    if nbr % D:
        raise ValueError(f"block rows ({nbr}) must divide over {D} shards")
    nbr_loc, L = nbr // D, m.row_len
    steps, loc = _ring_layout(m.cols, nbr_loc, D, L)
    placed = NamedSharding(sharding.mesh, P(sharding.axis))
    return DistBSRMatrix(
        blocks_t=jax.device_put(
            m.blocks_t.reshape(D, nbr_loc * L, B, B), placed),
        loc_cols=jax.device_put(loc, placed),
        steps=steps,
        n=m.n,
        block=B,
        ndev=D,
    )


def dist_bsr_matvec(dm: DistBSRMatrix, sharding):
    """Sharded matvec closure ``x: (k, n) -> (k, n)`` over the mesh.

    ``sharding`` is a :class:`~diaglib_tpu.parallel.VectorSharding` whose
    mesh axis has exactly ``dm.ndev`` devices.  The closure is jittable and
    drops straight into any solver as its ``matvec`` (the solvers constrain
    their (k, n) state along the same axis, so no resharding occurs).
    """
    mesh, axis = sharding.mesh, sharding.axis
    D = dm.ndev
    if mesh.shape[axis] != D:
        raise ValueError(
            f"matrix distributed over {D} shards but mesh axis "
            f"'{axis}' has {mesh.shape[axis]} devices")
    B = dm.block
    nbr_loc = dm.n_local // B

    def local(x_loc, blocks, loc_cols):
        # x_loc: (k, n_local); blocks/loc_cols: this device's (1, ...) data
        k = x_loc.shape[0]
        parts = []
        for s in dm.steps:
            if s == 0:
                parts.append(x_loc)
            else:
                # fetch the shard s hops up-ring: one collective permute
                perm = [(j, (j - s) % D) for j in range(D)]
                parts.append(jax.lax.ppermute(x_loc, axis, perm))
        halo = jnp.concatenate(parts, axis=1)
        xb = halo.reshape(k, len(parts) * nbr_loc, B).transpose(1, 0, 2)
        y = _row_spmm(xb, loc_cols[0], blocks[0])
        return y.transpose(1, 0, 2).reshape(k, nbr_loc * B)

    shmapped = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, axis), P(axis), P(axis)),
        out_specs=P(None, axis),
    )

    def mv(x):
        return shmapped(x, dm.blocks_t, dm.loc_cols)

    return mv
