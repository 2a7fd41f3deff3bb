"""Observability: convergence tables and timing reports.

The reference prints a per-iteration per-root table when ``verbose``
(diaglib.f90:381-385, format 1030/1040) and a cpu/wall timing summary per
driver (540-546).  In a jit-compiled solver, printing from inside the loop
would force host syncs, so this design returns the full convergence
history in the result object and renders the identical table *post hoc*;
wall timing is taken around the (blocking) solve by the caller.
"""

from __future__ import annotations

import sys

import numpy as np

__all__ = ["convergence_table", "print_convergence_table", "timing_report"]


def convergence_table(result, n_targ: int, solver: str = "Davidson-Liu",
                      tol: float = None) -> str:
    """Render the reference's verbose iteration table (format 1030/1040)."""
    eig_h = np.asarray(result.eig_history)
    rms_h = np.asarray(result.rms_history)
    max_h = np.asarray(result.max_history)
    n_iter = int(result.n_iter)
    lines = []
    head = f"{solver} iterations"
    if tol is not None:
        head += f" (tol={tol:10.2e})"
    bar = "-" * 66
    lines += [f"    {head}:", f"    {bar}",
              "       iter  root              eigenvalue         rms         max ok",
              f"    {bar}"]
    for it in range(n_iter):
        for i in range(n_targ):
            rms, mx = rms_h[it, i], max_h[it, i]
            ok = rms < (tol or np.inf) and mx < 10 * (tol or np.inf)
            lines.append(
                f"       {it+1:4d}  {i+1:4d}{eig_h[it, i]:24.12f}"
                f"{rms:12.4e}{mx:12.4e}  {'T' if ok else 'F'}")
        lines.append("")
    return "\n".join(lines)


def print_convergence_table(result, n_targ: int, solver: str = "Davidson-Liu",
                            tol: float = None, file=None):
    print(convergence_table(result, n_targ, solver, tol),
          file=file or sys.stdout)


def timing_report(solver: str, wall_s: float, n_iter: int, n_matvec: int,
                  file=None, includes_compile: bool = False):
    """Timing summary in the spirit of diaglib.f90:1835-1841 (the jitted
    loop fuses phases, so a single wall figure plus counters replaces the
    per-phase accumulators).  Set ``includes_compile`` when the timed call
    was a cold first run."""
    file = file or sys.stdout
    note = "  (includes XLA compile)" if includes_compile else ""
    print(f"  timings for {solver} (wall):", file=file)
    print(f"    total:                {wall_s:12.4f} s{note}", file=file)
    print(f"    iterations:           {n_iter:12d}", file=file)
    print(f"    operator applications:{n_matvec:12d}", file=file)


# one probe per backend: does this PJRT runtime implement the host
# callbacks jax.debug.print rides on?  (A runtime without them fails only
# at run time, after compilation succeeded.)
_DEBUG_CB_SUPPORT: dict = {}
_WARNED: set = set()


def _inflight_supported() -> bool:
    """True when jax.debug.print can actually execute on this backend.

    Probed by AOT-compiling and RUNNING a trivial debug.print program —
    lower/compile + execute works even when the caller is itself inside a
    jit trace (inflight_progress is invoked at solver trace time), because
    the compiled executable runs outside the tracing machinery.
    """
    import jax

    backend = jax.default_backend()
    if backend not in _DEBUG_CB_SUPPORT:
        def probe(x):
            jax.debug.print("", ordered=False)
            return x

        try:
            # np scalar, NOT jnp: inside an active trace a jnp literal
            # becomes tracer-backed and the compiled call would reject it
            arg = np.float32(0)
            compiled = jax.jit(probe).lower(arg).compile()
            jax.block_until_ready(compiled(arg))
            _DEBUG_CB_SUPPORT[backend] = True
        except Exception:
            _DEBUG_CB_SUPPORT[backend] = False
    return _DEBUG_CB_SUPPORT[backend]


def inflight_progress(name: str, it, n_act, eig, rms, rmx):
    """One live progress line per iteration (SolverOptions.verbose).

    The reference prints its per-root table as it iterates
    (diaglib.f90:459-464); the equivalent here is a ``jax.debug.print``
    host callback from inside the compiled while_loop — zero cost when
    verbose is off (the call is simply not traced in).

    On runtimes without host callbacks (probed once per backend) the live
    line degrades to a one-time warning instead of a run-time failure;
    the full table is still available post hoc via
    :func:`print_convergence_table` (the result carries the history).
    """
    import warnings

    import jax

    if not _inflight_supported():
        backend = jax.default_backend()
        if backend not in _WARNED:
            _WARNED.add(backend)
            warnings.warn(
                f"verbose in-flight progress disabled: backend {backend!r} "
                "has no host callbacks (jax.debug.print UNIMPLEMENTED); "
                "use print_convergence_table(result, ...) post hoc",
                RuntimeWarning, stacklevel=2)
        return
    jax.debug.print(
        name + " it={it} n_act={na} eig0={e:.12e} rms={r:.3e} max={m:.3e}",
        it=it, na=n_act, e=eig[0], r=jnp_max(rms), m=jnp_max(rmx),
        ordered=False)


def jnp_max(x):
    import jax.numpy as jnp

    return jnp.max(jnp.where(jnp.isfinite(x), x, 0.0))
