"""Multi-host (multi-process) execution: process-spanning meshes.

The reference is single-process Fortran (SURVEY.md §2.5 — no MPI/NCCL of
any kind); the multi-host path is a new capability ("1 card / 1 host /
>= 2 hosts").  Design:

* ``initialize()`` wraps :func:`jax.distributed.initialize` and, on CPU,
  selects the gloo collectives backend so the exact same code path is
  testable with N processes x M virtual host devices.
* ``global_mesh()`` builds a 1-D mesh over ALL global devices in
  process-major order: each host owns a contiguous range of the row
  dimension, so the ring-offset halo exchange of the distributed operators
  (ops/dist_bsr.py) crosses the network only at host boundaries — for a
  banded operator with offsets +-1, one intra-host hop per device pair
  and one network hop per host boundary, issued as a single ``ppermute``.
  Offset groups are processed in ascending ring distance (dist_bsr steps
  are sorted), so the s=0 local SpMM and the near fetches are issued
  before any long hop, letting the async collectives overlap the bulk of
  the local compute.
* ``make_global()`` / ``host_local_guess()`` build process-spanning
  ``jax.Array``s from per-host data — multi-process jit only accepts
  global arrays.

Everything downstream (VectorSharding, the sharded solvers, the
distributed operators) is mesh-agnostic: a process-spanning mesh drops in
wherever a single-process mesh did.
"""

from __future__ import annotations

import os

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .sharding import VectorSharding

__all__ = [
    "initialize",
    "global_mesh",
    "global_sharding",
    "make_global",
    "make_replicated",
]


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               **kwargs) -> None:
    """Join (or start) the multi-process JAX runtime.

    Pass the three arguments explicitly (on a GPU host:
    ``coordinator_address="localhost:<port>"``); only managed clusters
    detect them from the environment.  On the CPU
    backend the gloo cross-process collectives implementation is selected
    (the default CPU client has no cross-process transport).
    """
    # NOTE: must not query the backend here (jax.devices()/default_backend()
    # would initialize XLA before jax.distributed can) — inspect the config.
    platforms = jax.config.jax_platforms or ""
    if "cpu" in platforms or os.environ.get("JAX_PLATFORMS", "") == "cpu":
        try:
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        except Exception:
            pass  # older jaxlib: option absent, gloo already the default
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )


def global_mesh(axis_name: str = "n") -> Mesh:
    """1-D mesh over ALL global devices, process-major.

    ``jax.devices()`` orders devices by process id, so a contiguous block
    of mesh positions lives on each host — the layout the host-aware halo
    strategy above relies on.
    """
    return Mesh(np.array(jax.devices()), (axis_name,))


def global_sharding(axis_name: str = "n") -> VectorSharding:
    """VectorSharding over the process-spanning global mesh."""
    return VectorSharding(global_mesh(axis_name), axis_name)


def make_global(x, mesh: Mesh, spec: P):
    """Build a global jax.Array from a host-replicated numpy/jax array.

    Every process passes the SAME full array ``x`` (e.g. deterministically
    generated); each process materializes only its addressable shards.
    This is how operator pattern/slice data reaches a process-spanning
    mesh: multi-process jit rejects host-local (non-global) inputs.
    """
    x = np.asarray(x)
    sh = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(x.shape, sh, lambda idx: x[idx])


def make_replicated(x, mesh: Mesh):
    """Fully replicated global array from identical per-host data."""
    return make_global(x, mesh, P())
