"""Global configuration helpers for diaglib-tpu.

The reference library (diaglib.f90, real_precision.f90:1-4) is hard-wired to
double precision.  This library is dtype-polymorphic instead (the
mixed-precision ladders run an f32 stage before the f64 one): every solver
works in the dtype of its inputs and derives machine-epsilon-based thresholds (e.g. tol_ortho = 2*eps,
diaglib.f90:151) from that dtype.  ``enable_x64()`` is a convenience for tests
and CPU runs that want bit-comparable behavior with the Fortran reference.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

__all__ = [
    "enable_x64",
    "default_dtype",
    "eps",
    "tol_ortho",
    "enable_persistent_cache",
]


def enable_x64(enable: bool = True) -> None:
    """Enable float64 globally (matches the reference's ``dp = 8``)."""
    jax.config.update("jax_enable_x64", enable)


def default_dtype():
    """float64 if x64 is enabled, else float32."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def eps(dtype) -> float:
    """Machine epsilon of ``dtype`` (Fortran ``epsilon(one)``)."""
    return float(jnp.finfo(dtype).eps)


def tol_ortho(dtype) -> float:
    """Orthogonalization threshold, ``2 * epsilon`` (diaglib.f90:151)."""
    return 2.0 * eps(dtype)


DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".xla_cache")


def enable_persistent_cache(min_compile_secs: float = 1.0) -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    Compiling the big solver programs is set-up cost the reference never
    pays (gfortran once, Makefile:4-8); with the cache an unchanged
    program re-loads instead of recompiling.

    The directory is ``$JAX_COMPILATION_CACHE_DIR`` when that is set (and
    then no other directory is set), else the fixed ``<repo>/.xla_cache``:
    the path is part of the cache key, so it must not move between runs.
    Safe to call more than once.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
