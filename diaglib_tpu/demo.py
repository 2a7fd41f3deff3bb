"""Demo/test driver reproducing the reference's ``main.f90`` protocol.

Usage:
    python -m diaglib_tpu.demo symm   [--n 1000] [--n-want 10] [--tol 1e-8]
    python -m diaglib_tpu.demo geneig ...
    python -m diaglib_tpu.demo scflr  ...
    python -m diaglib_tpu.demo caslr  ...
    python -m diaglib_tpu.demo nonsym ...

Each subcommand mirrors one menu entry of the reference driver
(main.f90:26-45): build the same procedurally generated matrices, solve
densely as the oracle, run the corresponding iterative drivers, write the
same result files (lapack.txt, lobpcg.txt, davidson.txt, caslr.txt,
cashp.txt, caslr_eff.txt, nonsym.txt — eigenvalue + eigenvector with the
phase fixed so component 1 is positive, main.f90:337), and print the
per-iteration convergence tables.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from . import config
from .ops import bsr_matvec  # noqa: F401  (re-exported for examples)
from .problems import (
    casida_blocks,
    dense_matvec,
    diag_precnd,
    lrprec_eff,
    lrprec_std,
    metric_matrix,
    nonsym_matrix,
    symm_matrix,
)
from .reporting import print_convergence_table, timing_report
from .solvers import caslr, caslr_eff, davidson, gen_david, lobpcg, nonsym
from .types import SolverOptions
from .utils.guess import guess_evec


def _write_results(path, eig, evec, n_want):
    """Result file in the reference's format (main.f90:331-341)."""
    with open(path, "w") as f:
        for i in range(n_want):
            f.write(f"   eigenvalue # {i+1:6d}: {float(eig[i]):12.6f}\n")
            f.write("   eigenvector: \n")
            v = np.asarray(evec[i])
            if v[0] < 0:
                v = -v
            for off in range(0, len(v), 10):
                f.write("".join(f"{x:12.6f}" for x in v[off:off + 10]) + "\n")
            f.write("\n")


def _solve_time(fn):
    t0 = time.time()
    res = jax.block_until_ready(fn())
    return res, time.time() - t0


def cmd_symm(args):
    n, n_want, tol = args.n, args.n_want, args.tol
    n_eig = min(2 * n_want, n_want + 5)
    a = symm_matrix(n)
    diag = jnp.diagonal(a)
    # dense oracle on the host (scipy), like the other commands: the
    # reference's lapack.txt is a host dsyev (main.f90:321-342)
    import scipy.linalg

    ww, vv = scipy.linalg.eigh(np.asarray(a, np.float64))
    w, v = jnp.asarray(ww), jnp.asarray(vv)
    _write_results(os.path.join(args.out_dir, "lapack.txt"), w, v.T, n_want)
    opts = SolverOptions(n_targ=n_want, n_max=n_eig, max_iter=args.itmax,
                         tol=tol, max_dav=args.m_max, verbose=args.verbose)
    guess = guess_evec(4, jax.random.PRNGKey(args.seed), n, n_eig, diagonal=diag)

    res, dt = _solve_time(lambda: lobpcg(
        dense_matvec(a), diag_precnd(diag), guess, opts,
        key=jax.random.PRNGKey(args.seed)))
    print_convergence_table(res, n_want, "LOBPCG", tol)
    timing_report("lobpcg", dt, int(res.n_iter), int(res.n_matvec),
                  includes_compile=True)
    _write_results(os.path.join(args.out_dir, "lobpcg.txt"),
                   res.eig, res.evec, n_want)

    res, dt = _solve_time(lambda: davidson(
        dense_matvec(a), diag_precnd(diag), guess, opts,
        key=jax.random.PRNGKey(args.seed)))
    print_convergence_table(res, n_want, "Davidson-Liu", tol)
    timing_report("davidson", dt, int(res.n_iter), int(res.n_matvec),
                  includes_compile=True)
    _write_results(os.path.join(args.out_dir, "davidson.txt"),
                   res.eig, res.evec, n_want)
    _check(res, w, n_want, tol)


def cmd_geneig(args):
    n, n_want, tol = args.n, args.n_want, args.tol
    n_eig = min(2 * n_want, n_want + 5)
    a = symm_matrix(n)
    s = metric_matrix(n, jax.random.PRNGKey(args.seed))
    diag = jnp.diagonal(a)
    import scipy.linalg

    w, v = scipy.linalg.eigh(np.asarray(a), np.asarray(s))
    _write_results(os.path.join(args.out_dir, "lapack.txt"),
                   jnp.asarray(w), jnp.asarray(v).T, n_want)
    opts = SolverOptions(n_targ=n_want, n_max=n_eig, max_iter=args.itmax,
                         tol=tol, max_dav=args.m_max, verbose=args.verbose)
    guess = guess_evec(4, jax.random.PRNGKey(args.seed), n, n_eig, diagonal=diag)

    res, dt = _solve_time(lambda: lobpcg(
        dense_matvec(a), diag_precnd(diag), guess, opts,
        bvec=dense_matvec(s), key=jax.random.PRNGKey(args.seed)))
    print_convergence_table(res, n_want, "LOBPCG (generalized)", tol)
    timing_report("lobpcg", dt, int(res.n_iter), int(res.n_matvec),
                  includes_compile=True)
    _write_results(os.path.join(args.out_dir, "lobpcg.txt"),
                   res.eig, res.evec, n_want)

    res, dt = _solve_time(lambda: gen_david(
        dense_matvec(a), diag_precnd(diag), dense_matvec(s), guess, opts,
        key=jax.random.PRNGKey(args.seed)))
    print_convergence_table(res, n_want, "Generalized Davidson", tol)
    timing_report("gen_david", dt, int(res.n_iter), int(res.n_matvec),
                  includes_compile=True)
    _write_results(os.path.join(args.out_dir, "davidson.txt"),
                   res.eig, res.evec, n_want)
    _check(res, jnp.asarray(w), n_want, tol)


def _casida(args, tdscf):
    n, n_want, tol = args.n, args.n_want, args.tol
    n_eig = min(2 * n_want, n_want + 5)
    blk = casida_blocks(n, jax.random.PRNGKey(args.seed), tdscf=tdscf)
    import scipy.linalg

    e_full = np.block([[np.asarray(blk["aa"]), np.asarray(blk["bb"])],
                       [np.asarray(blk["bb"]), np.asarray(blk["aa"])]])
    s_full = np.block(
        [[np.asarray(blk["sigma"]), np.asarray(blk["delta"])],
         [-np.asarray(blk["delta"]), -np.asarray(blk["sigma"])]])
    ev, evec = scipy.linalg.eigh(s_full, e_full)
    omega = jnp.asarray(1.0 / ev[::-1][:n_want])
    _write_results(os.path.join(args.out_dir, "lapack.txt"), omega,
                   jnp.asarray(evec[:, ::-1][:, :n_want]).T, n_want)

    diag = jnp.diagonal(blk["aa"]) - jnp.diagonal(blk["sigma"])
    guess = guess_evec(4, jax.random.PRNGKey(args.seed), 2 * n, n_eig,
                       diagonal=diag)
    ops = dict(apbmul=dense_matvec(blk["apb"]), ambmul=dense_matvec(blk["amb"]),
               spdmul=dense_matvec(blk["spd"]), smdmul=dense_matvec(blk["smd"]))
    pc_std = lrprec_std(jnp.diagonal(blk["aa"]), jnp.diagonal(blk["sigma"]))
    pc_eff = lrprec_eff(jnp.diagonal(blk["aa"]), jnp.diagonal(blk["sigma"]))
    opts = SolverOptions(n_targ=n_want, n_max=n_eig, max_iter=args.itmax,
                         tol=tol, max_dav=args.m_max, verbose=args.verbose)

    res, dt = _solve_time(lambda: caslr(
        lrprec=pc_std, evec_guess=guess, options=opts, algorithm=0, **ops))
    print_convergence_table(res, n_want, "Casida LR (inverse pencil)", tol)
    timing_report("caslr", dt, int(res.n_iter), int(res.n_matvec),
                  includes_compile=True)
    _write_results(os.path.join(args.out_dir, "caslr.txt"),
                   res.eig, res.evec / np.sqrt(2.0), n_want)

    if not tdscf:
        # the reference runs Helmich-Paris only in test_caslr (i_alg=1 set
        # at main.f90:688, reset at 693); test_scflr never exercises it.
        # (caslr(algorithm=1) does also work on the tdscf blocks.)
        res, dt = _solve_time(lambda: caslr(
            lrprec=pc_std, evec_guess=guess, options=opts, algorithm=1,
            **ops))
        print_convergence_table(res, n_want, "Casida LR (Helmich-Paris)", tol)
        timing_report("caslr/hp", dt, int(res.n_iter), int(res.n_matvec),
                  includes_compile=True)
        _write_results(os.path.join(args.out_dir, "cashp.txt"),
                       res.eig, res.evec / np.sqrt(2.0), n_want)

    res, dt = _solve_time(lambda: caslr_eff(
        lrprec=pc_eff, evec_guess=guess, options=opts, **ops))
    print_convergence_table(res, n_want, "Casida LR (efficient)", tol)
    timing_report("caslr_eff", dt, int(res.n_iter), int(res.n_matvec),
                  includes_compile=True)
    _write_results(os.path.join(args.out_dir, "caslr_eff.txt"),
                   res.eig, res.evec / 2.0, n_want)
    _check(res, omega, n_want, tol)


def cmd_caslr(args):
    _casida(args, tdscf=False)


def cmd_scflr(args):
    _casida(args, tdscf=True)


def cmd_nonsym(args):
    n, n_want, tol = args.n, args.n_want, args.tol
    a = nonsym_matrix(n, jax.random.PRNGKey(1), variant=args.variant)
    diag = jnp.diagonal(a)
    import scipy.linalg

    w = np.sort(scipy.linalg.eig(np.asarray(a), right=False).real)
    _np = min(n_want, len(w))
    opts = SolverOptions(n_targ=n_want, n_max=n_want, max_iter=args.itmax,
                         tol=tol, max_dav=args.m_max, verbose=args.verbose)
    guess = guess_evec(6, jax.random.PRNGKey(args.seed), n, n_want,
                       diagonal=diag)
    res, dt = _solve_time(lambda: nonsym(
        dense_matvec(a), dense_matvec(a.T), diag_precnd(diag), guess, opts,
        side=args.side, key=jax.random.PRNGKey(args.seed)))
    print("  two-sided nonsymmetric Davidson "
          f"(side={args.side}), ok={bool(res.ok)}")
    timing_report("nonsym", dt, int(res.n_iter), int(res.n_matvec),
                  includes_compile=True)
    _write_results(os.path.join(args.out_dir, "nonsym.txt"),
                   res.eig, res.evec_r if args.side != 'l' else res.evec_l,
                   n_want)
    err = float(jnp.max(jnp.abs(res.eig[:_np] - jnp.asarray(w[:_np]))))
    print(f"  max |eig - dense| over {_np} roots: {err:.2e}")


def _check(res, oracle, n_want, tol):
    err = float(jnp.max(jnp.abs(res.eig[:n_want] - oracle[:n_want])))
    print(f"  converged: {bool(res.ok)}; max |eig - dense| = {err:.2e}")


def main(argv=None):
    config.enable_x64()
    p = argparse.ArgumentParser(prog="diaglib_tpu.demo", description=__doc__)
    p.add_argument("--n", type=int, default=1000)
    p.add_argument("--n-want", type=int, default=10)
    p.add_argument("--tol", type=float, default=1e-8)
    p.add_argument("--itmax", type=int, default=100)
    p.add_argument("--m-max", type=int, default=20,
                   help="max_dav (reference m_max, main.f90:18)")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--verbose", action="store_true",
                   help="live per-iteration progress (SolverOptions.verbose)")
    p.add_argument("--out-dir", default=".")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("symm")
    sub.add_parser("geneig")
    sub.add_parser("scflr")
    sub.add_parser("caslr")
    pn = sub.add_parser("nonsym")
    pn.add_argument("--side", default="c", choices=["r", "l", "s", "c"])
    pn.add_argument("--variant", type=int, default=4, choices=[1, 2, 3, 4])
    args = p.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    {"symm": cmd_symm, "geneig": cmd_geneig, "scflr": cmd_scflr,
     "caslr": cmd_caslr, "nonsym": cmd_nonsym}[args.cmd](args)


if __name__ == "__main__":
    main()
