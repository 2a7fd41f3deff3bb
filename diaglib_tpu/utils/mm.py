"""Gram and rotation contractions of the solvers, at a stated precision.

Every Gram-like or rotation contraction in the solvers goes through
``mm`` / ``mmT`` / ``mTm``.  Each dot states ``Precision.HIGHEST``: on a
GPU an f32 matmul may otherwise run in TF32 (about three decimal digits),
which the f32 tier of a mixed-precision ladder would read as lost
orthogonality and a stalled residual.

Float64 contractions longer than ``_CHUNK`` are split into a ``lax.scan``
of ``_CHUNK``-wide partial dots, each with one operand scaled by 2 and the
product halved.  Both are exact in binary floating point, so the result is
the same contraction; the scheme was a workaround for an emulated-f64
backend that lost digits on value-correlated products.  On native f64 it
only costs time; whether to keep it is a measurement (ROADMAP A3, C2).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["mm", "mmT", "mTm"]

_CHUNK = 4096
_HI = jax.lax.Precision.HIGHEST


def _dot(a, b):
    return jnp.matmul(a, b, precision=_HI)


def _scaled(a, b):
    return _dot(a, 2.0 * b) * 0.5


def _needs_chunking(dtype, k):
    return dtype == jnp.float64 and k > _CHUNK


def _chunk_sizes(k):
    nc = k // _CHUNK
    return nc, nc * _CHUNK


def mmT(a, b):
    """a @ b.T (Gram layout, contracting the last axes)."""
    k = a.shape[-1]
    if not _needs_chunking(a.dtype, k):
        return _scaled(a, b.T)
    nc, k_main = _chunk_sizes(k)
    aa = a[..., :k_main].reshape(a.shape[0], nc, _CHUNK).transpose(1, 0, 2)
    bb = b[..., :k_main].reshape(b.shape[0], nc, _CHUNK).transpose(1, 0, 2)

    def body(acc, xy):
        x, y = xy
        return acc + _scaled(x, y.T), None

    acc0 = jnp.zeros((a.shape[0], b.shape[0]), a.dtype)
    out, _ = jax.lax.scan(body, acc0, (aa, bb))
    if k_main < k:
        out = out + _scaled(a[..., k_main:], b[..., k_main:].T)
    return out


def mm(a, b):
    """a @ b (contract last dim of a with first of b)."""
    k = a.shape[-1]
    if not _needs_chunking(a.dtype, k):
        return _scaled(a, b)
    nc, k_main = _chunk_sizes(k)
    aa = a[:, :k_main].reshape(a.shape[0], nc, _CHUNK).transpose(1, 0, 2)
    bb = b[:k_main].reshape(nc, _CHUNK, b.shape[1])

    def body(acc, xy):
        x, y = xy
        return acc + _scaled(x, y), None

    acc0 = jnp.zeros((a.shape[0], b.shape[1]), a.dtype)
    out, _ = jax.lax.scan(body, acc0, (aa, bb))
    if k_main < k:
        out = out + _scaled(a[:, k_main:], b[k_main:])
    return out


def mTm(a, b):
    """a.T @ b (contract the first axes)."""
    k = a.shape[0]
    if not _needs_chunking(a.dtype, k):
        return _scaled(a.T, b)
    nc, k_main = _chunk_sizes(k)
    aa = a[:k_main].reshape(nc, _CHUNK, a.shape[1])
    bb = b[:k_main].reshape(nc, _CHUNK, b.shape[1])

    def body(acc, xy):
        x, y = xy
        return acc + _scaled(x.T, y), None

    acc0 = jnp.zeros((a.shape[1], b.shape[1]), a.dtype)
    out, _ = jax.lax.scan(body, acc0, (aa, bb))
    if k_main < k:
        out = out + _scaled(a[k_main:].T, b[k_main:])
    return out
