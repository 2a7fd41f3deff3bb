"""Smoke test of the main path on a GPU, through the public entry points.

    python chip_smoke.py                # one card: operator, flagship, drivers
    python chip_smoke.py --four-cards   # four cards: the sharded mesh phase

One card runs three phases:

1. operator: the plain BSR SpMM at the flagship geometry (n=65536, B=512,
   8 blocks per row), f64 and f32, 15 vectors, against a host NumPy f64
   computation over 16 sampled block rows and all their entries;
2. flagship: the mixed-precision ``davidson_ladder`` of the benchmark's
   headline cell (10 roots of 15 to 1e-10), its f64 residuals recomputed on
   the host by a blockwise matvec, its eigenvalues checked against
   ``lobpcg_ladder`` on the same stores;
3. drivers: the reference's n=1000 toy protocols for all six drivers
   against host LAPACK oracles (norm-wise relative error of the 10 wanted
   eigenvalues).

``--four-cards`` runs only the mesh phase: the flagship operator through
``distribute_bsr`` + ``dist_bsr_matvec`` driving a sharded f64 Davidson,
compared with the same solve on one card, plus the dense sharded dry run
of ``__graft_entry__``.

Every phase raises on failure, so the script exits non-zero and prints no
result line.  It needs a GPU (no CPU fallback, no interpret mode) and
``nvidia-smi``.  The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Times it prints are informational, labelled with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

N, B, BPR = 65536, 512, 8          # the flagship geometry
N_WANT, N_EIG = 10, 15
TOY_N = 1000


def card_info() -> str:
    """``nvidia-smi``'s name and power limit of every card (one per line)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (FileNotFoundError, subprocess.CalledProcessError,
            subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"nvidia-smi failed: {e}") from e
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    if not lines:
        raise RuntimeError("nvidia-smi reported no card")
    return "; ".join(lines)


def require_gpu(jax, count: int):
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"no GPU: jax.devices()[0] is {devs[0]}")
    if len(devs) < count:
        raise RuntimeError(f"need {count} GPUs, JAX sees {len(devs)}")
    return devs


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def _check(cond: bool, what: str):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def _flagship_stores(jax, jnp):
    from diaglib_tpu.ops import bsr_astype, random_bsr_spd

    m32 = random_bsr_spd(N, B, BPR, jax.random.PRNGKey(0), dtype=jnp.float32)
    return m32, bsr_astype(m32, jnp.float64)


def _host_pattern(m):
    rows, cols = np.asarray(m.rows), np.asarray(m.cols)
    start = np.searchsorted(rows, np.arange(m.n // m.block + 1))
    return cols, start


def _host_rows_matvec(m32, x, block_rows):
    """Independent host f64 reference: y = A x on the given block rows."""
    cols, start = _host_pattern(m32)
    Bk = m32.block
    x = np.asarray(x, np.float64)
    out = {}
    for r in block_rows:
        e0, e1 = int(start[r]), int(start[r + 1])
        blocks = np.asarray(m32.blocks_t[e0:e1], np.float64)
        acc = np.zeros((x.shape[0], Bk))
        for j, e in enumerate(range(e0, e1)):
            c = int(cols[e])
            acc += x[:, c * Bk:(c + 1) * Bk] @ blocks[j]
        out[r] = acc
    return out


def phase_operator(jax, card):
    import jax.numpy as jnp

    from diaglib_tpu.ops import bsr_matvec

    m32, m64 = _flagship_stores(jax, jnp)
    rng = np.random.default_rng(0)
    rows = sorted(rng.choice(N // B, size=16, replace=False).tolist())
    x64 = jax.random.normal(jax.random.PRNGKey(1), (N_EIG, N), jnp.float64)
    mv = jax.jit(lambda m, x: bsr_matvec(m)(x))
    for name, m, limit in (("f64", m64, 1e-12), ("f32", m32, 1e-5)):
        x = x64.astype(m.blocks_t.dtype)
        y = np.asarray(mv(m, x), np.float64)
        ref = _host_rows_matvec(m32, x, rows)
        err = max(np.max(np.abs(y[:, r * B:(r + 1) * B] - ref[r]))
                  for r in rows)
        scale = max(np.max(np.abs(ref[r])) for r in rows)
        rel = err / scale
        print(f"operator {name}: rel max err {rel:.3e} over {len(rows)} "
              f"block rows (limit {limit:g})", flush=True)
        _check(rel <= limit, f"SpMM {name} rel err {rel:.3e} > {limit:g}")

        rep = 50
        many = jax.jit(lambda m, x: jax.lax.fori_loop(
            0, rep, lambda i, acc: bsr_matvec(m)(acc) * 1e-3, x))
        jax.block_until_ready(many(m, x))
        t0 = time.perf_counter()
        jax.block_until_ready(many(m, x))
        dt = (time.perf_counter() - t0) / rep
        item = m.blocks_t.dtype.itemsize
        nbytes = m.nnz * item + 2 * N_EIG * N * item
        print(f"operator {name}: {dt * 1e3:.4f} ms/matvec, "
              f"{nbytes / dt / 1e9:.1f} GB/s, k={N_EIG} [{card}]",
              flush=True)


def phase_flagship(jax, card):
    import jax.numpy as jnp

    from diaglib_tpu import SolverOptions
    from diaglib_tpu.ops import bsr_diagonal, bsr_matvec
    from diaglib_tpu.problems import diag_precnd
    from diaglib_tpu.solvers import davidson_ladder, lobpcg_ladder

    m32, m64 = _flagship_stores(jax, jnp)
    opts = SolverOptions(n_targ=N_WANT, n_max=N_EIG, max_iter=150, tol=1e-10,
                         max_dav=10)
    g = jnp.zeros((N_EIG, N), jnp.float64)

    def tiers(m32, m64):
        return (bsr_matvec(m32), diag_precnd(bsr_diagonal(m32)),
                bsr_matvec(m64), diag_precnd(bsr_diagonal(m64)))

    run = jax.jit(lambda m32, m64, g, k: davidson_ladder(
        *tiers(m32, m64), g, opts, lo_tol=2e-6, lo_iter=35, key=k))
    t0 = time.perf_counter()
    res = jax.block_until_ready(run(m32, m64, g, jax.random.PRNGKey(1)))
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(run(m32, m64, g, jax.random.PRNGKey(2)))
    t_steady = time.perf_counter() - t0
    print(f"flagship davidson_ladder: ok={bool(res.ok)} "
          f"iters={int(res.n_iter)} matvecs={int(res.n_matvec)}; "
          f"compile+first solve {t_first:.1f} s, steady solve "
          f"{t_steady:.3f} s [{card}]", flush=True)
    _check(bool(res.ok), "flagship davidson_ladder ok")

    # independent f64 residual rms of the returned pairs (host, blockwise)
    evec = np.asarray(res.evec[:N_WANT], np.float64)
    eig = np.asarray(res.eig[:N_WANT], np.float64)
    av = _host_rows_matvec(m32, evec, range(N // B))
    av = np.concatenate([av[r] for r in range(N // B)], axis=1)
    rms = np.linalg.norm(av - eig[:, None] * evec, axis=1) / np.sqrt(N)
    print(f"flagship host residual rms: max {np.max(rms):.3e} "
          f"(limit 1e-10)", flush=True)
    _check(np.max(rms) <= 1e-10, f"host residual rms {np.max(rms):.3e}")

    run_l = jax.jit(lambda m32, m64, g, k: lobpcg_ladder(
        *tiers(m32, m64), g, opts, lo_tol=2e-6, lo_iter=70, key=k))
    res_l = jax.block_until_ready(run_l(m32, m64, g, jax.random.PRNGKey(1)))
    _check(bool(res_l.ok), "flagship lobpcg_ladder ok")
    rel = np.max(np.abs(np.asarray(res_l.eig[:N_WANT]) - eig) / np.abs(eig))
    print(f"flagship lobpcg_ladder: ok={bool(res_l.ok)} "
          f"iters={int(res_l.n_iter)}, eig rel diff {rel:.3e} "
          f"(limit 1e-9)", flush=True)
    _check(rel <= 1e-9, f"davidson vs lobpcg eig rel diff {rel:.3e}")


def _toy_runs(jax, jnp):
    """(name, jitted solve, host oracle eigenvalues) of the reference's
    n=1000 toy protocols (main.f90:14-18 config)."""
    import scipy.linalg

    from diaglib_tpu import SolverOptions
    from diaglib_tpu.problems import (
        casida_blocks,
        dense_matvec,
        diag_precnd,
        lrprec_eff,
        lrprec_std,
        metric_matrix,
        nonsym_matrix,
        symm_matrix,
    )
    from diaglib_tpu.solvers import (
        caslr,
        caslr_eff,
        davidson,
        gen_david,
        lobpcg,
        nonsym,
    )
    from diaglib_tpu.utils.guess import guess_evec

    n = TOY_N
    opts = SolverOptions(n_targ=N_WANT, n_max=N_EIG, max_iter=100, tol=1e-8,
                         max_dav=20)
    g = jnp.zeros((N_EIG, n), jnp.float64)
    a = symm_matrix(n)
    s = metric_matrix(n, jax.random.PRNGKey(1))
    w_a = scipy.linalg.eigh(np.asarray(a), eigvals_only=True)
    w_as = scipy.linalg.eigh(np.asarray(a), np.asarray(s), eigvals_only=True)
    mv, pc = dense_matvec(a), diag_precnd(jnp.diagonal(a))

    blk = casida_blocks(n, jax.random.PRNGKey(1))
    host = {k: np.asarray(v) for k, v in blk.items()}
    e_full = np.block([[host["aa"], host["bb"]], [host["bb"], host["aa"]]])
    s_full = np.block([[host["sigma"], host["delta"]],
                       [-host["delta"], -host["sigma"]]])
    w_lr = 1.0 / scipy.linalg.eigh(s_full, e_full, eigvals_only=True)[::-1]
    dlr = jnp.diagonal(blk["aa"]) - jnp.diagonal(blk["sigma"])
    glr = guess_evec(4, jax.random.PRNGKey(1), 2 * n, N_EIG, diagonal=dlr)
    a_d, s_d = jnp.diagonal(blk["aa"]), jnp.diagonal(blk["sigma"])
    lr_ops = dict(apbmul=dense_matvec(blk["apb"]),
                  ambmul=dense_matvec(blk["amb"]),
                  spdmul=dense_matvec(blk["spd"]),
                  smdmul=dense_matvec(blk["smd"]))

    an = nonsym_matrix(n, jax.random.PRNGKey(1), variant=4)
    w_n = np.sort(scipy.linalg.eig(np.asarray(an), right=False).real)
    on = SolverOptions(n_targ=N_WANT, n_max=N_WANT, max_iter=100, tol=1e-8,
                       max_dav=20)
    gn = guess_evec(6, jax.random.PRNGKey(1), n, N_WANT,
                    diagonal=jnp.diagonal(an))
    key = jax.random.PRNGKey(2)

    return [
        ("davidson", lambda: jax.jit(
            lambda g, k: davidson(mv, pc, g, opts, key=k))(g, key), w_a),
        ("lobpcg", lambda: jax.jit(
            lambda g, k: lobpcg(mv, pc, g, opts, key=k))(g, key), w_a),
        ("gen_david", lambda: jax.jit(lambda g, k: gen_david(
            mv, pc, dense_matvec(s), g, opts, key=k))(g, key), w_as),
        ("caslr_alg0", lambda: jax.jit(lambda g: caslr(
            lrprec=lrprec_std(a_d, s_d), evec_guess=g, options=opts,
            algorithm=0, **lr_ops))(glr), w_lr),
        ("caslr_alg1", lambda: jax.jit(lambda g: caslr(
            lrprec=lrprec_std(a_d, s_d), evec_guess=g, options=opts,
            algorithm=1, **lr_ops))(glr), w_lr),
        ("caslr_eff", lambda: jax.jit(lambda g: caslr_eff(
            lrprec=lrprec_eff(a_d, s_d), evec_guess=g, options=opts,
            **lr_ops))(glr), w_lr),
        ("nonsym_c", lambda: jax.jit(lambda g, k: nonsym(
            dense_matvec(an), dense_matvec(an.T), diag_precnd(
                jnp.diagonal(an)), g, on, side="c", key=k))(gn, key), w_n),
    ]


def phase_drivers(jax, card):
    import jax.numpy as jnp

    for name, solve, oracle in _toy_runs(jax, jnp):
        t0 = time.perf_counter()
        res = jax.block_until_ready(solve())
        dt = time.perf_counter() - t0
        # norm-wise relative error over the wanted window: the lowest
        # generalized eigenvalue (7e-4, metric condition ~1e10) is known
        # to the oracle itself only to an absolute, not a relative, level
        eig, ref = np.asarray(res.eig[:N_WANT]), oracle[:N_WANT]
        rel = np.max(np.abs(eig - ref)) / np.max(np.abs(ref))
        print(f"driver {name}: ok={bool(res.ok)} iters={int(res.n_iter)} "
              f"eig rel err {rel:.3e} (limit 1e-8); compile+solve "
              f"{dt:.1f} s [{card}]", flush=True)
        _check(bool(res.ok), f"{name} ok")
        _check(rel <= 1e-8, f"{name} eig rel err {rel:.3e}")


def phase_mesh(jax, card):
    import jax.numpy as jnp

    from diaglib_tpu import SolverOptions
    from diaglib_tpu.ops import (
        bsr_diagonal,
        bsr_matvec,
        dist_bsr_matvec,
        distribute_bsr,
    )
    from diaglib_tpu.parallel import VectorSharding, make_mesh
    from diaglib_tpu.problems import diag_precnd
    from diaglib_tpu.solvers import davidson

    devices = jax.devices()[:4]
    sh = VectorSharding(make_mesh(devices))
    _, m64 = _flagship_stores(jax, jnp)
    diag = bsr_diagonal(m64)
    dm = distribute_bsr(m64, sh)
    for d in devices:
        used = (d.memory_stats() or {}).get("bytes_in_use", 0)
        print(f"mesh: {d} holds {used / 2**30:.2f} GiB after "
              f"distribute_bsr", flush=True)
    opts = SolverOptions(n_targ=N_WANT, n_max=N_EIG, max_iter=150, tol=1e-10,
                         max_dav=10)
    g = jnp.zeros((N_EIG, N), jnp.float64)
    key = jax.random.PRNGKey(1)

    def timed(run, *args):
        """(result, compile+first solve s, second solve s)"""
        t0 = time.perf_counter()
        res = jax.block_until_ready(run(*args))
        t1 = time.perf_counter()
        jax.block_until_ready(run(*args))
        return res, t1 - t0, time.perf_counter() - t1

    res_d, c_d, t_d = timed(jax.jit(lambda dm, diag, g, k: davidson(
        dist_bsr_matvec(dm, sh), diag_precnd(diag), g, opts, key=k,
        sharding=sh)), dm, diag, g, key)
    res_s, c_s, t_s = timed(jax.jit(lambda m, diag, g, k: davidson(
        bsr_matvec(m), diag_precnd(diag), g, opts, key=k)), m64, diag, g, key)
    rel = np.max(np.abs(np.asarray(res_d.eig[:N_WANT])
                        - np.asarray(res_s.eig[:N_WANT]))
                 / np.abs(np.asarray(res_s.eig[:N_WANT])))
    print(f"mesh: sharded davidson ok={bool(res_d.ok)} "
          f"iters={int(res_d.n_iter)} compile+first solve {c_d:.1f} s, "
          f"solve {t_d:.3f} s; one-card ok={bool(res_s.ok)} "
          f"iters={int(res_s.n_iter)} compile+first solve {c_s:.1f} s, "
          f"solve {t_s:.3f} s; eig rel diff {rel:.3e} (limit 1e-10) "
          f"[{card}]", flush=True)
    _check(bool(res_d.ok) and bool(res_s.ok), "sharded and one-card ok")
    _check(rel <= 1e-10, f"sharded vs one-card eig rel diff {rel:.3e}")

    import __graft_entry__

    __graft_entry__.dryrun_multichip(len(devices))


def select_phases(four_cards: bool):
    if four_cards:
        return [phase_mesh]
    return [phase_operator, phase_flagship, phase_drivers]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the sharded mesh phase over four GPUs")
    args = p.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)
    from diaglib_tpu.config import enable_persistent_cache

    cache = enable_persistent_cache()
    devices = require_gpu(jax, 4 if args.four_cards else 1)
    card = card_info()
    print(f"card: {card}", flush=True)
    print(f"jax {jax.__version__}; compile cache {cache}", flush=True)
    for phase in select_phases(args.four_cards):
        phase(jax, card)
    print(result_line(devices), flush=True)


if __name__ == "__main__":
    main()
