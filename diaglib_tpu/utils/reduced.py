"""Host-LAPACK execution of the small replicated reduced dense solves.

The reduced matrices in every driver are tiny (<= (dim_dav*n_max)^2, a few
hundred squared) while the O(n) work is on device.  The reference keeps
this split — O(n) in user callbacks, reduced solves in LAPACK
(diaglib.f90:135-138).  Here the reduced solves run where ``method`` says.

``method`` semantics everywhere:

* "device" — jnp.linalg (XLA's native implementations: LAPACK on the CPU,
  cuSOLVER on a GPU);
* "jacobi" — the on-device cyclic-Jacobi kernels (utils/jacobi.py), whose
  compiled program size is tiny and dimension-independent;
* "host"  — jax.pure_callback to LAPACK (for runtimes that support host
  callbacks);
* "auto"  — "device".
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import jacobi as _jacobi
from .mm import mm, mTm

__all__ = ["resolve", "eigh", "svd", "cholesky", "eigh_gen"]

_METHODS = ("auto", "device", "host", "jacobi")


def resolve(method: str) -> str:
    if method not in _METHODS:
        raise ValueError(f"reduced_solver must be one of {_METHODS}, got {method}")
    return "device" if method == "auto" else method


def use_host(method: str) -> bool:
    return resolve(method) == "host"


def _f64(x):
    return jnp.asarray(x, jnp.float64)


def eigh(a, method: str = "device", v0=None, off_tol: float = 0.0):
    """``v0``/``off_tol``: warm-start basis and relaxed off-norm target for
    the Jacobi route (utils/jacobi.py); ignored by the exact device/host
    LAPACK routes, which need no warm start."""
    method = resolve(method)
    if method == "device":
        return jnp.linalg.eigh(a)
    if method == "jacobi":
        return _jacobi.jacobi_eigh(a, v0=v0, off_tol=off_tol)
    n = a.shape[-1]

    def cb(a_):
        import scipy.linalg

        w, v = scipy.linalg.eigh(np.asarray(a_, np.float64))
        return w, v

    spec = (jax.ShapeDtypeStruct((n,), jnp.float64),
            jax.ShapeDtypeStruct((n, n), jnp.float64))
    w, v = jax.pure_callback(cb, spec, _f64(a), vmap_method="sequential")
    return w.astype(a.dtype), v.astype(a.dtype)


def svd(a, method: str = "device", off_tol: float = 0.0):
    method = resolve(method)
    if method == "device":
        return jnp.linalg.svd(a)
    if method == "jacobi":
        # one-sided (Hestenes): ~4-8x cheaper than the augmented 2L form
        # and small singular values keep full relative accuracy (column
        # norms, no Gram squaring) — round-4 kernel, utils/jacobi.py
        return _jacobi.jacobi_svd_onesided(a, off_tol=off_tol)
    n, m = a.shape[-2:]
    k = min(n, m)

    def cb(a_):
        import scipy.linalg

        u, s, vt = scipy.linalg.svd(np.asarray(a_, np.float64))
        return u, s, vt

    spec = (jax.ShapeDtypeStruct((n, n), jnp.float64),
            jax.ShapeDtypeStruct((k,), jnp.float64),
            jax.ShapeDtypeStruct((m, m), jnp.float64))
    u, s, vt = jax.pure_callback(cb, spec, _f64(a), vmap_method="sequential")
    return u.astype(a.dtype), s.astype(a.dtype), vt.astype(a.dtype)


def cholesky(a, method: str = "device"):
    """Lower Cholesky; returns NaNs on failure like jnp.linalg.cholesky."""
    method = resolve(method)
    if method in ("device", "jacobi"):  # no Jacobi Cholesky: XLA's own
        return jnp.linalg.cholesky(a)
    n = a.shape[-1]

    def cb(a_):
        import scipy.linalg

        c, info = scipy.linalg.lapack.dpotrf(np.asarray(a_, np.float64),
                                             lower=1, clean=1)
        if info != 0:
            c = np.full_like(c, np.nan)
        return c

    spec = jax.ShapeDtypeStruct((n, n), jnp.float64)
    c = jax.pure_callback(cb, spec, _f64(a), vmap_method="sequential")
    return c.astype(a.dtype)


def eigh_gen(s, a, method: str = "device", off_tol: float = 0.0):
    """Generalized symmetric pencil s x = e a x, a SPD; dsygv itype=1
    normalization (x^T a x = I).  ``off_tol`` relaxes the Jacobi route's
    off-norm target (both the whitening and the pencil eigh)."""
    method = resolve(method)
    n = a.shape[-1]
    if method == "device":
        from jax.scipy.linalg import solve_triangular

        lo = jnp.linalg.cholesky(a)
        tmp = solve_triangular(lo, s, lower=True)
        std = solve_triangular(lo, tmp.T, lower=True)
        e, y = jnp.linalg.eigh(0.5 * (std + std.T))
        x = solve_triangular(lo, y, lower=True, trans=1)
        return e, x
    if method == "jacobi":
        # Cholesky-free whitening: a = V D V^T -> a^{-1/2} = V D^{-1/2} V^T
        # (avoids big triangular solves; a is identity-padded SPD)
        d, v = _jacobi.jacobi_eigh(a, off_tol=off_tol)
        inv_sqrt = 1.0 / jnp.sqrt(jnp.maximum(d, jnp.finfo(a.dtype).tiny))
        w_half = v * inv_sqrt[None, :]
        std = mTm(w_half, mm(s, w_half))
        e, y = _jacobi.jacobi_eigh(0.5 * (std + std.T), off_tol=off_tol)
        return e, mm(w_half, y)

    def cb(s_, a_):
        import scipy.linalg

        w, v = scipy.linalg.eigh(np.asarray(s_, np.float64),
                                 np.asarray(a_, np.float64))
        return w, v

    spec = (jax.ShapeDtypeStruct((n,), jnp.float64),
            jax.ShapeDtypeStruct((n, n), jnp.float64))
    w, v = jax.pure_callback(cb, spec, _f64(s), _f64(a),
                             vmap_method="sequential")
    return w.astype(a.dtype), v.astype(a.dtype)
