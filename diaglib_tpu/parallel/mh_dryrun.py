"""Multi-process (multi-host) dry run: N processes x M virtual CPU devices.

Validates the process-spanning path end to end on one machine (SURVEY.md
§2.5 north star; the reference is single-process Fortran, §2.5):

* ``jax.distributed.initialize`` over a local coordinator (gloo CPU
  collectives),
* a global mesh spanning both processes (parallel/multihost.py),
* the sharded Davidson solver on (a) a dense operator with
  GSPMD-inserted collectives and (b) the row-partitioned distributed BSR
  operator whose ppermute halo exchange now crosses the process boundary,
* eigenvalues cross-checked against a dense local oracle on every
  process.

Run one worker per process::

    python -m diaglib_tpu.parallel.mh_dryrun --process-id 0 --num-processes 2 \
        --coordinator 127.0.0.1:PORT --local-devices 4

or launch the whole fleet in one call with :func:`launch` (used by
``__graft_entry__.dryrun_multihost`` and tests/test_multihost.py).
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys


def _worker(process_id: int, num_processes: int, coordinator: str,
            local_devices: int) -> None:
    # platform/device-count setup must precede any backend initialization
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={local_devices}"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from diaglib_tpu import SolverOptions
    from diaglib_tpu.ops import (
        bsr_diagonal,
        bsr_to_dense,
        dist_bsr_matvec,
        distribute_bsr,
        random_bsr_spd,
    )
    from diaglib_tpu.parallel import VectorSharding
    from diaglib_tpu.parallel.multihost import (
        global_mesh,
        initialize,
        make_global,
        make_replicated,
    )
    from diaglib_tpu.problems import symm_matrix
    from diaglib_tpu.solvers import davidson

    initialize(coordinator, num_processes, process_id)
    D = jax.device_count()
    assert D == num_processes * local_devices, (D, num_processes,
                                                local_devices)
    mesh = global_mesh()
    sh = VectorSharding(mesh)
    n_want, n_eig = 2, 4
    opts = SolverOptions(n_targ=n_want, n_max=n_eig, max_iter=60, tol=1e-7)

    # ---- dense operator, GSPMD collectives across the process boundary ----
    n = 32 * D
    a_host = np.asarray(symm_matrix(n))
    a_g = make_replicated(a_host, mesh)
    guess = make_global(np.zeros((n_eig, n)), mesh, P(None, "n"))

    @jax.jit
    def step_dense(a, guess):
        res = davidson(lambda x: x @ a.T, lambda s, x: x / (jnp.diag(a) + s),
                       guess, opts, key=jax.random.PRNGKey(1), sharding=sh)
        return res.eig, res.ok

    eig, ok = jax.block_until_ready(step_dense(a_g, guess))
    w = np.linalg.eigvalsh(a_host)
    err_dense = float(np.max(np.abs(np.asarray(eig[:n_want]) - w[:n_want])))
    assert bool(ok), "multihost dense Davidson did not converge"
    assert err_dense < 1e-6, f"multihost dense eig err {err_dense}"

    # ---- distributed BSR operator: halo ppermute crosses processes ----
    B = 8
    nb = 4 * B * D
    m = random_bsr_spd(nb, B, 2, jax.random.PRNGKey(7), dtype=jnp.float64,
                       n_low_modes=8)  # deterministic: same on every process
    dm_g = distribute_bsr(m, sh)
    diag_g = make_global(np.asarray(bsr_diagonal(m)), mesh, P("n"))
    guess_b = make_global(np.zeros((n_eig, nb)), mesh, P(None, "n"))

    @jax.jit
    def step_bsr(dm, diag, guess):
        res = davidson(dist_bsr_matvec(dm, sh),
                       lambda s, x: x / jnp.where(jnp.abs(diag + s) > 1e-5,
                                                  diag + s, 1.0),
                       guess, opts, key=jax.random.PRNGKey(1), sharding=sh)
        return res.eig, res.ok

    eig_b, ok_b = jax.block_until_ready(step_bsr(dm_g, diag_g, guess_b))
    wb = np.linalg.eigvalsh(np.asarray(bsr_to_dense(m)))
    err_bsr = float(np.max(np.abs(np.asarray(eig_b[:n_want]) - wb[:n_want])))
    assert bool(ok_b), "multihost BSR Davidson did not converge"
    assert err_bsr < 1e-6, f"multihost BSR eig err {err_bsr}"

    print(f"MH_DRYRUN_OK process {process_id}/{num_processes} "
          f"devices={D} dense_err={err_dense:.2e} bsr_err={err_bsr:.2e}",
          flush=True)


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(num_processes: int = 2, local_devices: int = 4,
           timeout: float = 600.0) -> str:
    """Spawn the worker fleet; returns combined output, raises on failure."""
    coordinator = f"127.0.0.1:{free_port()}"
    procs = []
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)  # workers pin the platform themselves
    for pid in range(num_processes):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "diaglib_tpu.parallel.mh_dryrun",
             "--process-id", str(pid),
             "--num-processes", str(num_processes),
             "--coordinator", coordinator,
             "--local-devices", str(local_devices)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env,
        ))
    outputs = []
    failed = []
    for pid, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise RuntimeError(f"multihost worker {pid} timed out")
        outputs.append(out)
        if p.returncode != 0 or "MH_DRYRUN_OK" not in out:
            failed.append(pid)
    combined = "\n".join(outputs)
    if failed:
        raise RuntimeError(
            f"multihost workers {failed} failed:\n{combined}")
    return combined


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--coordinator", required=True)
    p.add_argument("--local-devices", type=int, default=4)
    args = p.parse_args(argv)
    _worker(args.process_id, args.num_processes, args.coordinator,
            args.local_devices)


if __name__ == "__main__":
    main()
