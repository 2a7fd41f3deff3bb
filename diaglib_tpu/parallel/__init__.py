"""Distributed execution layer (new capability vs the serial reference).

The reference is single-process Fortran (SURVEY.md §2.5).  Here the scalable
dimension is the vector length n: every (k, n) block — expansion space,
operator products, residuals — is sharded along n over a 1-D device mesh,
Gram/Rayleigh-Ritz contractions become psum-style collectives inserted by
XLA's SPMD partitioner, and the small reduced problems stay replicated.

Multi-host: ``multihost.initialize`` + ``multihost.global_mesh`` span the
mesh over processes (one per host; N CPU processes in tests), and
everything downstream is mesh-agnostic.  See parallel/multihost.py.
"""

from .multihost import (
    global_mesh,
    global_sharding,
    initialize,
    make_global,
    make_replicated,
)
from .sharding import VectorSharding, make_mesh

__all__ = [
    "VectorSharding",
    "make_mesh",
    "initialize",
    "global_mesh",
    "global_sharding",
    "make_global",
    "make_replicated",
]
