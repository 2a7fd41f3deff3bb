"""Two-sided Davidson for real nonsymmetric matrices.

Re-designs the reference's ``nonsym_driver`` (diaglib.f90:2252-2943):
one-sided Davidson passes (right with A, left with A^T) driven through a
``side`` selector — 'r', 'l', 's'/'c' (both, consecutively: right pass, then
left pass seeded from the right eigenvectors, diaglib.f90:2880-2903) — with a
final ``svd_biortho`` of (evec_l, evec_r).

Split of the work: all O(n) linear algebra (matvecs, Gram updates, Ritz
vectors, residuals, orthogonalization) stays on device; the small
nonsymmetric reduced eigenproblem runs on the host as LAPACK ``dgeev``
(SURVEY.md §7: the reduced matrix is tiny and replicated, the host
roundtrip is the pragmatic choice).  Two drivers reach it:
``driver="jit"`` keeps the whole loop in one ``lax.while_loop`` with a
``jax.pure_callback``; ``driver="host"`` orchestrates the loop from Python
with the device steps jit-compiled, for runtimes whose PJRT has no host
callbacks.  The host solve also
performs the two serial post-processing steps of the reference:

* ``sort_eigenpairs`` — ascending selection sort on the real parts with
  complex pairs (|wi| > 1e-12) parked at the array tail
  (diaglib.f90:2945-3017).  Like the reference, the targeted roots are the
  lowest REAL eigenvalues: complex pairs above the target window are
  handled (parked) transparently, but a spectrum whose complex pairs sit
  *inside* the window is outside this algorithm family's contract and
  stalls convergence;
* root homing — overlaps of previous vs current reduced eigenvectors build a
  max-overlap permutation with tie-breaking fallbacks
  (diaglib.f90:2539-2696).  The reference's bookkeeping arrays are indexed
  past their declared first dimension (e.g. ``overlap_idx_r(j,1)`` with
  ``j > 2`` on a (2,n_max) array, diaglib.f90:2550-2565) — storage aliasing
  that scrambles the tie-break data; this rebuild implements the *intended*
  logic with correctly shaped arrays.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ortho.core import ortho_cd, ortho_vs_x
from ..types import NonsymResult, SolverOptions
from ..utils.guess import check_guess
from ..utils.mm import mm, mTm, mmT
from ..utils.masking import gather_rows, prefix_lock, prefix_mask, scatter_rows

__all__ = ["nonsym", "nonsym_pass", "NonsymPassResult",
           "nonsym_seed_left", "nonsym_finalize"]

_TOL_IM = 1.0e-12

_CALLBACK_SUPPORT: dict = {}


def _callbacks_supported() -> bool:
    """Whether this backend's PJRT implements host send/recv callbacks.

    Probed once per backend with a trivial jitted pure_callback, so
    driver='auto' keeps the fused while_loop wherever it actually works.
    """
    backend = jax.default_backend()
    if backend not in _CALLBACK_SUPPORT:
        def cb(x):
            return np.asarray(x)

        try:
            jax.block_until_ready(jax.jit(lambda x: jax.pure_callback(
                cb, jax.ShapeDtypeStruct((), jnp.float32), x,
                vmap_method="sequential"))(jnp.float32(0)))
            _CALLBACK_SUPPORT[backend] = True
        except Exception:
            _CALLBACK_SUPPORT[backend] = False
    return _CALLBACK_SUPPORT[backend]


def _host_reduced_eig(a_red, ldu, n_sort, do_homing, copy_r, copy_l, n_max,
                      out_dtype=np.float64):
    """dgeev + sort + root homing on the host (numpy), static shapes.

    a_red: (L, L) with the leading ldu x ldu block valid (G[i,j] = s_i.A s_j).
    Returns wr (L,), vr (L, L), vl (L, L), found_im flag; columns sorted
    ascending by real part over the leading ``n_sort`` slots with complex
    pairs parked at the tail of the valid block, then permuted by maximum
    overlap with the previous reduced eigenvectors (copy_r/copy_l, zero
    padded (L, 2*n_max)).
    """
    import scipy.linalg

    L = a_red.shape[0]
    ldu = int(ldu)
    n_sort = min(int(n_sort), ldu)
    m2 = 2 * n_max
    a = np.asarray(a_red[:ldu, :ldu], dtype=np.float64)
    wr_s, wi_s, vl_s, vr_s, info = scipy.linalg.lapack.dgeev(
        a, compute_vl=1, compute_vr=1
    )
    if info != 0:  # pragma: no cover - matches the reference's hard stop
        raise RuntimeError(f"dgeev failed, info={info}")
    wr = wr_s.copy()
    wi = wi_s.copy()
    vr = vr_s.copy()
    vl = vl_s.copy()

    def swap(i, j):
        if i == j:
            return
        wr[[i, j]] = wr[[j, i]]
        wi[[i, j]] = wi[[j, i]]
        vr[:, [i, j]] = vr[:, [j, i]]
        vl[:, [i, j]] = vl[:, [j, i]]

    # selection sort with complex parking (sort_eigenpairs semantics)
    mask = np.ones(ldu, dtype=bool)
    for i in range(n_sort):
        cand = np.where(mask, wr, np.inf)
        idx = int(np.argmin(cand))
        if abs(wi[idx]) > _TOL_IM:
            fin = ldu - 1
            while fin >= 0 and not mask[fin]:
                fin -= 1
            mask[fin] = False
            swap(fin, idx)
            cand = np.where(mask, wr, np.inf)
            idx = int(np.argmin(cand))
        mask[i] = False
        swap(i, idx)

    found_im = bool(np.any(np.abs(wi[:n_max]) > _TOL_IM))

    if do_homing:
        vr_pad = np.zeros((ldu, m2))
        vl_pad = np.zeros((ldu, m2))
        ncols = min(m2, ldu)
        vr_pad[:, :ncols] = vr[:, :ncols]
        vl_pad[:, :ncols] = vl[:, :ncols]
        ov_r = np.asarray(copy_r)[:ldu, :].T @ vr_pad  # (m2, m2)
        ov_l = np.asarray(copy_l)[:ldu, :].T @ vl_pad

        def pick(ov):
            first_idx = np.zeros(n_max, dtype=int)
            first_val = np.zeros(n_max)
            second_idx = np.zeros(n_max, dtype=int)
            second_val = np.zeros(n_max)
            moved = False
            for j in range(n_max):
                col = np.abs(ov[:, j])
                k1 = int(np.argmax(col))
                first_idx[j], first_val[j] = k1, ov[k1, j]
                if k1 != j:
                    moved = True
                col2 = col.copy()
                col2[k1] = -np.inf
                k2 = int(np.argmax(col2))
                second_idx[j], second_val[j] = k2, ov[k2, j]
            return first_idx, first_val, second_idx, second_val, moved

        idx_r, val_r, idx2_r, val2_r, mv_r = pick(ov_r)
        idx_l, val_l, _, _, mv_l = pick(ov_l)
        found_er = mv_r or mv_l

        def has_double(idx):
            return len(np.unique(idx)) != len(idx)

        double_r, double_l = has_double(idx_r), has_double(idx_l)
        if double_r and not double_l:
            idx_r = idx_l.copy()
        elif double_l and not double_r:
            idx_l = idx_r.copy()
        elif double_r and double_l:
            # resolve collisions on the right side via second-best overlaps
            for j in range(n_max):
                for k in range(n_max):
                    if k != j and idx_r[j] == idx_r[k]:
                        if val2_r[j] > val2_r[k]:
                            idx_r[j] = idx2_r[j]
                        else:
                            idx_r[k] = idx2_r[k]
            if has_double(idx_r):
                idx_r = np.arange(n_max)
                idx_l = np.arange(n_max)
            else:
                idx_l = idx_r.copy()

        if np.any(idx_r != idx_l):
            if np.sum(val_r) > np.sum(val_l):
                idx_l = idx_r.copy()
            else:
                idx_r = idx_l.copy()

        if found_er:
            valid = idx_r < ldu
            perm = np.where(valid, idx_r, np.arange(n_max))
            wr[:n_max] = wr[perm]
            wi[:n_max] = wi[perm]
            vr[:, :n_max] = vr[:, perm]
            vl[:, :n_max] = vl[:, perm]

    wr_out = np.zeros(L)
    vr_out = np.zeros((L, L))
    vl_out = np.zeros((L, L))
    wr_out[:ldu] = wr
    vr_out[:ldu, :ldu] = vr
    vl_out[:ldu, :ldu] = vl
    return (
        wr_out.astype(out_dtype),
        vr_out.astype(out_dtype),
        vl_out.astype(out_dtype),
        np.bool_(found_im),
    )


def _compact_valid(wr, wi, vr, vl, valid):
    """Stable permutation moving valid entries to the leading positions
    (pads to the tail), so the device pipeline sees the host layout: the
    genuine block in the leading ldu slots.  O(L^2) comparison counts
    instead of cumsum (see utils/jacobi.py rank_argsort on why)."""
    L = valid.shape[0]
    idx = jnp.arange(L)
    before = idx[None, :] < idx[:, None]
    n_valid = jnp.sum(valid)
    pos_v = jnp.sum(valid[None, :] & before, axis=1)
    pos_i = n_valid + jnp.sum((~valid)[None, :] & before, axis=1)
    pos = jnp.where(valid, pos_v, pos_i)
    perm = jnp.zeros((L,), jnp.int32).at[pos].set(idx.astype(jnp.int32))
    return wr[perm], wi[perm], vr[:, perm], vl[:, perm]


def _swap1(x, i, j):
    xi, xj = x[i], x[j]
    return x.at[i].set(xj).at[j].set(xi)


def _device_sort_park(wr, wi, ldu, n_sort, n_max):
    """Selection sort with complex parking on device — the exact
    semantics of the host loop in ``_host_reduced_eig`` (which mirrors
    the reference's ``sort_eigenpairs``, diaglib.f90:2945-3017): for each
    of the leading ``n_sort`` slots pick the smallest remaining real
    part; a complex candidate (|wi| > tol_im) is first swapped to the
    last unconsumed slot, then the pick repeats once.  Returns the
    permutation to apply to the eigenvector columns."""
    L = wr.shape[0]
    idx = jnp.arange(L)
    inf = jnp.asarray(jnp.inf, wr.dtype)

    def step(i, carry):
        wr_c, wi_c, perm, mask = carry

        def do(args):
            wr_c, wi_c, perm, mask = args
            cand = jnp.where(mask, wr_c, inf)
            pick1 = jnp.argmin(cand).astype(jnp.int32)
            is_c = jnp.abs(wi_c[pick1]) > _TOL_IM
            fin = (L - 1 - jnp.argmax(mask[::-1])).astype(jnp.int32)

            def park(args):
                wr_c, wi_c, perm, mask = args
                mask = mask.at[fin].set(False)
                wr_c = _swap1(wr_c, fin, pick1)
                wi_c = _swap1(wi_c, fin, pick1)
                perm = _swap1(perm, fin, pick1)
                cand2 = jnp.where(mask, wr_c, inf)
                return (wr_c, wi_c, perm, mask,
                        jnp.argmin(cand2).astype(jnp.int32))

            def nopark(args):
                wr_c, wi_c, perm, mask = args
                return wr_c, wi_c, perm, mask, pick1

            wr_c, wi_c, perm, mask, pick = jax.lax.cond(
                is_c, park, nopark, (wr_c, wi_c, perm, mask))
            mask = mask.at[i].set(False)
            wr_c = _swap1(wr_c, i, pick)
            wi_c = _swap1(wi_c, i, pick)
            perm = _swap1(perm, i, pick)
            return wr_c, wi_c, perm, mask

        return jax.lax.cond(i < n_sort, do, lambda c: c,
                            (wr_c, wi_c, perm, mask))

    wr_s, wi_s, perm, _ = jax.lax.fori_loop(
        0, 2 * n_max, step,
        (wr, wi, idx.astype(jnp.int32), idx < ldu))
    return wr_s, wi_s, perm


def _device_homing(wr, wi, vr, vl, copy_r, copy_l, ldu, n_max):
    """Max-overlap root homing on device — the vectorized twin of the
    host logic (reference semantics diaglib.f90:2539-2696): first/second
    best overlaps per root, collision resolution via second-best values,
    identity fallback when collisions persist, and cross-side
    arbitration by total overlap."""
    L = wr.shape[0]
    m2 = 2 * n_max
    ar = jnp.arange(n_max, dtype=jnp.int32)
    colmask = jnp.arange(m2) < jnp.minimum(m2, ldu)
    rowmask = (jnp.arange(L) < ldu)[:, None]
    vrp = jnp.where(colmask[None, :], vr[:, :m2], 0.0)
    vlp = jnp.where(colmask[None, :], vl[:, :m2], 0.0)
    ov_r = mTm(jnp.where(rowmask, copy_r, 0.0), vrp)
    ov_l = mTm(jnp.where(rowmask, copy_l, 0.0), vlp)

    def pick(ov):
        colabs = jnp.abs(ov[:, :n_max])
        k1 = jnp.argmax(colabs, axis=0).astype(jnp.int32)
        v1 = ov[k1, ar]
        colabs2 = colabs.at[k1, ar].set(-jnp.inf)
        k2 = jnp.argmax(colabs2, axis=0).astype(jnp.int32)
        v2 = ov[k2, ar]
        return k1, v1, k2, v2, jnp.any(k1 != ar)

    idx_r, val_r, idx2_r, val2_r, mv_r = pick(ov_r)
    idx_l, val_l, _, _, mv_l = pick(ov_l)
    found_er = mv_r | mv_l

    not_eye = ~jnp.eye(n_max, dtype=bool)

    def has_double(idx):
        return jnp.any((idx[:, None] == idx[None, :]) & not_eye)

    double_r, double_l = has_double(idx_r), has_double(idx_l)

    def fix(t, idx):
        j, k = t // n_max, t % n_max
        collide = (k != j) & (idx[j] == idx[k])
        prefer_j = val2_r[j] > val2_r[k]
        newj = jnp.where(collide & prefer_j, idx2_r[j], idx[j])
        newk = jnp.where(collide & ~prefer_j, idx2_r[k], idx[k])
        return idx.at[j].set(newj).at[k].set(newk)

    idx_res = jax.lax.fori_loop(0, n_max * n_max, fix, idx_r)
    still = has_double(idx_res)
    both = jnp.where(still, ar, idx_res)
    idx_r_f = jnp.where(double_r & ~double_l, idx_l,
                        jnp.where(double_l & ~double_r, idx_r,
                                  jnp.where(double_r & double_l, both,
                                            idx_r)))
    idx_l_f = jnp.where(double_r & ~double_l, idx_l,
                        jnp.where(double_l & ~double_r, idx_r,
                                  jnp.where(double_r & double_l, both,
                                            idx_l)))
    any_diff = jnp.any(idx_r_f != idx_l_f)
    use_r = jnp.sum(val_r) > jnp.sum(val_l)
    final_idx = jnp.where(any_diff & ~use_r, idx_l_f, idx_r_f)

    permn = jnp.where(final_idx < ldu, final_idx, ar)
    perm = jnp.where(jnp.arange(L) < n_max,
                     jnp.pad(permn, (0, L - n_max)),
                     jnp.arange(L, dtype=jnp.int32))
    perm = jnp.where(found_er, perm, jnp.arange(L, dtype=jnp.int32))
    return wr[perm], wi[perm], vr[:, perm], vl[:, perm]


def _device_reduced_eig(g, ldu, n_sort, do_homing, copy_r, copy_l, n_max,
                        lda_pad, off_tol=0.0):
    """Fully on-device twin of ``_host_reduced_eig``: Eberlein
    norm-reducing Jacobi eigensolver (utils/eberlein.py) + parking sort +
    root homing, dispatched on the smallest prefix bucket covering
    ``ldu``.  Removes the host round trips entirely — the whole nonsym
    pass stays one ``lax.while_loop`` even on runtimes without host
    callbacks."""
    from ..utils.eberlein import eberlein_eig
    from ..utils.masking import bucketed_switch

    n_sort = jnp.minimum(n_sort, ldu)

    def make(L):
        def run(_):
            wr, wi, vr, vl = eberlein_eig(g[:L, :L], off_tol=off_tol)
            # pads (zero rows/cols of g beyond ldu) are exactly decoupled:
            # identify their eigenpairs by support on the pad rows, then
            # compact genuine entries to the leading ldu slots (host layout)
            pad_rows = (jnp.arange(L) >= ldu)[:, None]
            valid = jnp.sum(jnp.where(pad_rows, vr * vr, 0.0), axis=0) < 0.5
            wr, wi, vr, vl = _compact_valid(wr, wi, vr, vl, valid)
            wr, wi, perm = _device_sort_park(wr, wi, ldu, n_sort, n_max)
            vr = vr[:, perm]
            vl = vl[:, perm]
            found_im = jnp.any(
                jnp.abs(jnp.where(jnp.arange(L) < n_max, wi, 0.0)) > _TOL_IM)
            wr2, _, vr2, vl2 = _device_homing(
                wr, wi, vr, vl, copy_r[:L], copy_l[:L], ldu, n_max)
            use_h = do_homing
            wr = jnp.where(use_h, wr2, wr)
            vr = jnp.where(use_h, vr2, vr)
            vl = jnp.where(use_h, vl2, vl)
            rowv = (jnp.arange(L) < ldu)[:, None]
            colv = (jnp.arange(L) < ldu)[None, :]
            wr = jnp.where(jnp.arange(L) < ldu, wr, 0.0)
            vr = jnp.where(rowv & colv, vr, 0.0)
            vl = jnp.where(rowv & colv, vl, 0.0)
            padn = ((0, lda_pad - L), (0, lda_pad - L))
            return (jnp.pad(wr, (0, lda_pad - L)), jnp.pad(vr, padn),
                    jnp.pad(vl, padn), found_im)
        return run

    return bucketed_switch(make, ldu, lda_pad, 2 * n_max)


class _NonsymState(NamedTuple):
    it: jax.Array
    space: jax.Array     # (lda_pad, n) expansion rows
    aspace: jax.Array    # op @ space rows
    ldu: jax.Array
    n_act: jax.Array
    m_dim: jax.Array
    fresh: jax.Array     # True on the first iteration and right after restart
    copy_r: jax.Array    # (lda_pad, 2*n_max) previous reduced right vectors
    copy_l: jax.Array
    eig: jax.Array
    evec: jax.Array
    done: jax.Array
    rms: jax.Array
    rmx: jax.Array
    found_im: jax.Array
    ok: jax.Array
    ortho_ok: jax.Array
    n_matvec: jax.Array
    eig_h: jax.Array
    rms_h: jax.Array
    max_h: jax.Array


# fallback program memo for operators that cannot carry attributes
# (functools.partial, C callables): SMALL and bounded — each entry's
# programs close over the operator, which at flagship scale holds a
# multi-GB block store, so deep caching would pin gigabytes for the
# process lifetime (round-2 VERDICT Weak #5)
_FALLBACK_PROGRAMS: "OrderedDict" = __import__(
    "collections").OrderedDict()
_FALLBACK_MAX = 4


def nonsym_programs_clear():
    """Drop all cached nonsym pass programs (and the operator closures
    they pin).  Programs attached to operator closures die with them;
    this clears the bounded fallback memo for attribute-less callables."""
    _FALLBACK_PROGRAMS.clear()


def _pass_programs(op, precnd, options: SolverOptions, use_left: bool,
                   sharding, n: int, dtype_name: str):
    """Compiled device programs for one one-sided pass, memoized on the
    (operator, preconditioner, options, side, sharding, n, dtype) key —
    ``_nonsym_pass`` runs twice per consecutive solve and repeatedly in
    benchmarks/ladders; rebuilding the jitted step functions per call
    would recompile every time (callables are cached by identity: hold
    your matvec closure stable across calls to benefit).

    The memo lives ON the operator callable itself (``op.__dict__``), so
    its lifetime — and that of the captured operator data, gigabytes at
    flagship scale — is exactly the caller's operator lifetime: drop the
    matvec closure and the programs (plus whatever they close over) are
    collectible.  Callables without a ``__dict__`` fall back to a bounded
    ``_FALLBACK_PROGRAMS`` memo (at most ``_FALLBACK_MAX`` entries)."""
    # a traced use_left flag is not hashable; such programs are
    # side-polymorphic, so one memo entry serves both sides
    key = (precnd, options,
           use_left if isinstance(use_left, bool) else "traced",
           sharding, n, dtype_name)
    try:
        memo = op.__dict__.setdefault("_nonsym_pass_programs", {})
        fallback = False
    except AttributeError:
        memo = _FALLBACK_PROGRAMS
        key = (id(op), key)
        fallback = True
    if key in memo:
        return memo[key]
    value = _build_pass_programs(op, precnd, options, use_left, sharding, n,
                                 dtype_name)
    from jax._src.core import trace_state_clean

    if not trace_state_clean():
        # built while tracing (a jitted ladder/driver): any array constant
        # the closures captured is a tracer of THAT trace — storing it
        # would leak into later calls (observed: device-driver trace
        # poisoning the host driver's programs).  Use once, don't store.
        return value
    memo[key] = value
    if fallback:
        while len(_FALLBACK_PROGRAMS) > _FALLBACK_MAX:
            _FALLBACK_PROGRAMS.popitem(last=False)
    return value


def _build_pass_programs(op, precnd, options: SolverOptions, use_left: bool,
                         sharding, n: int, dtype_name: str):
    from ..parallel.sharding import constrainers

    dtype = jnp.dtype(dtype_name)
    vec, _ = constrainers(sharding)
    n_targ, n_max = options.n_targ, options.n_max
    lda = options.dim_dav * n_max
    lda_pad = lda + n_max
    max_iter = options.max_iter
    # trace-independent Python/numpy scalars: these are captured by the
    # memoized step closures, so they must NOT be jnp values (under an
    # active trace jnp lifts even constants to tracers, which would leak
    # through the memo into later traces)
    sqrtn = float(np.sqrt(n))
    tol_rms = float(options.tol)
    tol_max = float(options.tol_max)

    # the host solve always runs dgeev in f64; results come back in the
    # solver's working precision so an f32 ladder stage stays f32 end to end
    host = functools.partial(_host_reduced_eig, n_max=n_max,
                             out_dtype=np.dtype(dtype_name))
    out_spec = (
        jax.ShapeDtypeStruct((lda_pad,), dtype),
        jax.ShapeDtypeStruct((lda_pad, lda_pad), dtype),
        jax.ShapeDtypeStruct((lda_pad, lda_pad), dtype),
        jax.ShapeDtypeStruct((), jnp.bool_),
    )

    def cond(s: _NonsymState):
        return (~s.ok) & (s.it < max_iter)

    def step_pre(s: _NonsymState):
        """Device work up to the reduced solve: matvec block + Gram."""
        ldu_new = s.ldu + s.n_act
        amask = jnp.arange(n_max) < s.n_act
        blk = gather_rows(s.space, s.ldu, n_max, count=s.n_act)
        ablk = op(blk)
        ablk = jnp.where(amask[:, None], ablk, 0.0)
        aspace = scatter_rows(s.aspace, ablk, s.ldu)

        col_ok = prefix_mask(lda_pad, ldu_new)
        outer = col_ok[:, None] & col_ok[None, :]
        # right pass: G[i,j] = s_i . (A s_j); left pass: G[i,j] = l_i^T A l_j
        # = (A^T l_i) . l_j (diaglib.f90:2488-2494) — both reduce A in the
        # current basis.  ``use_left`` may be a TRACED flag (one compiled
        # side-polymorphic pass program serves both sides — the op then
        # differs only in its input arrays): the two Grams are exact
        # transposes of each other, so one product + a select suffices.
        if isinstance(use_left, bool):
            g = mmT(aspace, s.space) if use_left else mmT(s.space, aspace)
        else:
            g0 = mmT(s.space, aspace)
            g = jnp.where(use_left, g0.T, g0)
        g = jnp.where(outer, g, 0.0)

        n_sort = jnp.where(s.fresh, n_max, n_max + s.n_act)
        do_homing = (~s.fresh)
        return aspace, g, ldu_new, n_sort, do_homing

    def step_post(s: _NonsymState, aspace, ldu_new, wr, vr, vl, found_im):
        """Device work after the reduced solve: Ritz, residuals, expand."""
        n_matvec = s.n_matvec + s.n_act
        col_ok = prefix_mask(lda_pad, ldu_new)
        eig = wr[:n_max]
        cr = vr[:, :n_max]
        cl = vl[:, :n_max]
        if isinstance(use_left, bool):
            c_use = cl if use_left else cr
        else:
            c_use = jnp.where(use_left, cl, cr)

        evec = mTm(c_use, s.space)
        r = mTm(c_use, aspace) - eig[:, None] * evec

        active = (~s.done) & (jnp.arange(n_max) < n_targ)
        rms = jnp.where(active, jnp.linalg.norm(r, axis=1) / sqrtn, s.rms)
        rmx = jnp.where(active, jnp.max(jnp.abs(r), axis=1), s.rmx)

        conv = (rms < tol_rms) & (rmx < tol_max) & (s.it > 0)
        done = prefix_lock(s.done, conv, n_targ)
        ok = jnp.all(jnp.where(jnp.arange(n_max) < n_targ, done, True))

        eig_h = s.eig_h.at[s.it].set(eig - options.shift)
        rms_h = s.rms_h.at[s.it].set(rms)
        max_h = s.max_h.at[s.it].set(rmx)
        if options.verbose:
            from ..reporting import inflight_progress
            inflight_progress("nonsym", s.it, s.n_act, eig_h[s.it],
                              rms, rmx)


        copy_r = jnp.zeros((lda_pad, 2 * n_max), dtype).at[:, : 2 * n_max].set(
            vr[:, : 2 * n_max])
        copy_l = jnp.zeros((lda_pad, 2 * n_max), dtype).at[:, : 2 * n_max].set(
            vl[:, : 2 * n_max])

        n_frozen = jnp.sum(done, dtype=jnp.int32)
        n_act_new = (n_max - n_frozen).astype(jnp.int32)

        def expand(_):
            umask = jnp.arange(n_max) < n_act_new
            rblk = gather_rows(r, n_frozen, n_max, count=n_act_new)
            pre = precnd(-eig[n_frozen], rblk)
            pre = jnp.where(umask[:, None], pre, 0.0)
            unew, o_done = ortho_vs_x(s.space, pre, xmask=col_ok,
                                      umask=umask)
            return (scatter_rows(s.space, unew, ldu_new), aspace,
                    ldu_new, n_act_new, s.m_dim + 1, jnp.asarray(False),
                    s.ortho_ok & o_done)

        def restart(_):
            ev, _, cd_ok = ortho_cd(evec)
            z = jnp.zeros_like(s.space)
            return (scatter_rows(z, ev, 0), jnp.zeros_like(aspace),
                    jnp.asarray(0, jnp.int32), jnp.asarray(n_max, jnp.int32),
                    jnp.asarray(1, jnp.int32), jnp.asarray(True),
                    s.ortho_ok & cd_ok)

        def finish(_):
            return (s.space, aspace, ldu_new, s.n_act, s.m_dim,
                    jnp.asarray(False), s.ortho_ok)

        (space2, aspace2, ldu2, n_act2, m_dim2, fresh2,
         ortho_ok2) = jax.lax.cond(
            ok, finish,
            lambda _: jax.lax.cond(s.m_dim < options.dim_dav, expand,
                                   restart, None),
            None,
        )

        return _NonsymState(
            it=s.it + 1, space=space2, aspace=aspace2, ldu=ldu2,
            n_act=n_act2, m_dim=m_dim2, fresh=fresh2,
            copy_r=copy_r, copy_l=copy_l,
            eig=eig, evec=evec, done=done, rms=rms, rmx=rmx,
            found_im=s.found_im | found_im, ok=ok, ortho_ok=ortho_ok2,
            n_matvec=n_matvec,
            eig_h=eig_h, rms_h=rms_h, max_h=max_h,
        )

    def body(s: _NonsymState):
        aspace, g, ldu_new, n_sort, do_homing = step_pre(s)
        wr, vr, vl, found_im = jax.pure_callback(
            host, out_spec, g, ldu_new, n_sort, do_homing, s.copy_r, s.copy_l,
            vmap_method="sequential",
        )
        return step_post(s, aspace, ldu_new, wr, vr, vl, found_im)

    def body_device(s: _NonsymState):
        aspace, g, ldu_new, n_sort, do_homing = step_pre(s)
        # adaptive Eberlein off-norm target (utils/jacobi.py contract);
        # root homing relies on eigenVECTOR overlaps, so keep an extra
        # order of margin vs the symmetric drivers and a tighter cap
        prev_rms = jnp.min(jnp.where(~s.done, s.rms, jnp.inf))
        off_tol = jnp.clip(1e-3 * prev_rms, 0.0, 1e-6)
        wr, vr, vl, found_im = _device_reduced_eig(
            g, ldu_new, n_sort, do_homing, s.copy_r, s.copy_l, n_max,
            lda_pad, off_tol=off_tol)
        return step_post(s, aspace, ldu_new, wr, vr, vl, found_im)

    def make_init(guess):
        z = vec(jnp.zeros((lda_pad, n), dtype))
        return _NonsymState(
            it=jnp.asarray(0, jnp.int32),
            space=vec(scatter_rows(z, guess, 0)),
            aspace=z,
            ldu=jnp.asarray(0, jnp.int32),
            n_act=jnp.asarray(n_max, jnp.int32),
            m_dim=jnp.asarray(1, jnp.int32),
            fresh=jnp.asarray(True),
            copy_r=jnp.zeros((lda_pad, 2 * n_max), dtype),
            copy_l=jnp.zeros((lda_pad, 2 * n_max), dtype),
            eig=jnp.zeros((n_max,), dtype),
            evec=vec(jnp.zeros((n_max, n), dtype)),
            done=jnp.zeros((n_max,), bool),
            rms=jnp.full((n_max,), jnp.inf, dtype),
            rmx=jnp.full((n_max,), jnp.inf, dtype),
            found_im=jnp.asarray(False),
            ok=jnp.asarray(False),
            ortho_ok=jnp.asarray(True),
            n_matvec=jnp.asarray(0, jnp.int32),
            eig_h=jnp.zeros((max_iter, n_max), dtype),
            rms_h=jnp.full((max_iter, n_max), jnp.inf, dtype),
            max_h=jnp.full((max_iter, n_max), jnp.inf, dtype),
        )

    @jax.jit
    def pre_and_cond(s):
        return cond(s), step_pre(s)

    # one fused device program per host-loop iteration: apply the reduced
    # solve results (step_post) AND produce the next iteration's reduced
    # problem (step_pre) + continue flag.  Fusing post+pre halves the
    # per-iteration dispatch count; the state + aspace are donated.
    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def post_then_pre(s, aspace, ldu_new, wr, vr, vl, found_im):
        s2 = step_post(s, aspace, ldu_new, wr, vr, vl, found_im)
        return s2, cond(s2), step_pre(s2)

    return (make_init, cond, body, body_device, pre_and_cond,
            post_then_pre, host)


def _nonsym_pass(op, precnd, guess, options: SolverOptions, use_left: bool,
                 key, sharding=None, driver: str = "auto"):
    """One one-sided Davidson pass.

    ``op`` is A for the right pass and A^T for the left pass; ``use_left``
    selects which set of reduced eigenvectors drives the Ritz vectors and
    residuals (VL for the left pass, diaglib.f90:2712, 2717).

    ``driver`` picks how the reduced nonsymmetric eigensolve runs:
    "jit" keeps the whole loop in one ``lax.while_loop`` with the host
    dgeev reached through a ``pure_callback`` (callback-capable runtimes);
    "device" keeps the whole loop in one ``lax.while_loop`` with the
    reduced solve fully ON DEVICE (Eberlein norm-reducing Jacobi,
    utils/eberlein.py) — no host involvement at all; "host" orchestrates
    the loop from Python — the device steps before/after the reduced
    solve stay jit-compiled, the (tiny, replicated) reduced matrix
    round-trips to the host — kept as the cross-check and for spectra
    outside the device solver's contract.  "auto" probes callback support
    once per backend and picks "jit" when available, "device" otherwise.
    """
    guess = check_guess(jnp.asarray(guess), key)
    (make_init, cond, body, body_device, pre_and_cond, post_then_pre,
     host) = _pass_programs(
        op, precnd, options, use_left, sharding, guess.shape[1],
        jnp.dtype(guess.dtype).name)
    init = make_init(guess)

    if driver == "auto":
        driver = "jit" if _callbacks_supported() else "device"
    if driver == "jit":
        return jax.lax.while_loop(cond, body, init)
    if driver == "device":
        return jax.lax.while_loop(cond, body_device, init)
    if driver != "host":
        raise ValueError(
            "driver must be 'auto', 'jit', 'device' or 'host'")

    # host-orchestrated loop: device steps jit-compiled, reduced dgeev on
    # the host between them (no PJRT callback support needed).  Two host
    # round trips per iteration — one fused dispatch (post+pre), one
    # batched fetch of the continue flag + all six host inputs.
    s = init
    cont, (aspace, g, ldu_new, n_sort, do_homing) = pre_and_cond(s)
    while True:
        cont_h, g_h, ldu_h, ns_h, dh_h, cr_h, cl_h = jax.device_get(
            (cont, g, ldu_new, n_sort, do_homing, s.copy_r, s.copy_l))
        if not bool(cont_h):
            return s
        wr, vr, vl, fim = host(g_h, int(ldu_h), int(ns_h), bool(dh_h),
                               cr_h, cl_h)
        s, cont, (aspace, g, ldu_new, n_sort, do_homing) = post_then_pre(
            s, aspace, ldu_new, jnp.asarray(wr), jnp.asarray(vr),
            jnp.asarray(vl), jnp.asarray(bool(fim)))


def nonsym(matvec, matvec_l, precnd, evec_guess, options: SolverOptions,
           side: str = "c", *, key=None, sharding=None,
           driver: str = "auto"):
    """Two-sided Davidson for a real nonsymmetric matrix.

    Args:
      matvec: A applied to row vectors; matvec_l: A^T applied to row vectors
        (only needed for sides 'l', 's', 'c').
      precnd: ``(shift, block) -> block`` like the symmetric drivers.
      evec_guess: (n_max, n) guess rows (right guess; the left pass is
        seeded from the converged right eigenvectors, diaglib.f90:2892-2901).
      side: 'r' right only, 'l' left only, 's'/'c' both consecutively (the
        reference demotes 's' to consecutive, diaglib.f90:2398-2406).
      driver: "jit" (single lax.while_loop, host dgeev via callback —
        needs a callback-capable PJRT), "device" (single lax.while_loop,
        reduced solve fully on device via the Eberlein norm-reducing
        Jacobi in utils/eberlein.py — works everywhere, jittable), "host"
        (Python-orchestrated loop for callback-less runtimes; the call
        itself must not be wrapped in jax.jit), or "auto" (probes
        callback support once per backend: "jit" when available, else
        "device").

    Returns NonsymResult.  For 'c'/'s', ``ok`` additionally requires the
    left-pass eigenvalues to match the right-pass ones within tol
    (diaglib.f90:2887-2890 stops; here it is reported, not fatal), and
    (evec_l, evec_r) are svd-biorthonormalized (diaglib.f90:2908-2914).
    """
    if side not in ("r", "l", "s", "c"):
        raise ValueError("side must be one of 'r', 'l', 's', 'c'")
    return _nonsym_impl(matvec, matvec_l, precnd, evec_guess, options, side,
                        key=key, sharding=sharding, driver=driver)


def _nonsym_impl(matvec, matvec_l, precnd, evec_guess,
                 options: SolverOptions, side: str, *, key=None,
                 sharding=None, driver: str = "auto"):
    if key is None:
        key = jax.random.PRNGKey(0)
    kr, kl = jax.random.split(key)
    evec_guess = jnp.asarray(evec_guess)
    n = evec_guess.shape[1]
    n_max = options.n_max
    dtype = evec_guess.dtype

    if side == "r" or side == "l":
        op = matvec if side == "r" else matvec_l
        out = _nonsym_pass(op, precnd, evec_guess, options,
                           use_left=(side == "l"), key=kr, sharding=sharding,
                           driver=driver)
        zero_v = jnp.zeros((n_max, n), dtype)
        zero_h = jnp.zeros_like(out.rms_h)
        is_r = side == "r"
        return NonsymResult(
            eig=out.eig - options.shift,
            evec_r=out.evec if is_r else zero_v,
            evec_l=zero_v if is_r else out.evec,
            ok=out.ok, n_iter=out.it, n_matvec=out.n_matvec, done=out.done,
            rms_history_r=out.rms_h if is_r else zero_h,
            max_history_r=out.max_h if is_r else zero_h,
            rms_history_l=zero_h if is_r else out.rms_h,
            max_history_l=zero_h if is_r else out.max_h,
            eig_history=out.eig_h,
            ortho_ok=out.ortho_ok,
        )

    # consecutive: right pass, then left pass seeded from evec_r
    out_r = _nonsym_pass(matvec, precnd, evec_guess, options,
                         use_left=False, key=kr, sharding=sharding,
                         driver=driver)
    guess_l, seed_ok = nonsym_seed_left(out_r.evec)
    out_l = _nonsym_pass(matvec_l, precnd, guess_l, options,
                         use_left=True, key=kl, sharding=sharding,
                         driver=driver)
    return _consecutive_result(out_r, out_l, seed_ok, options)


def nonsym_seed_left(evec_r):
    """Left-pass seed from converged right eigenvectors: orthonormalized
    copy (diaglib.f90:2892-2901).  Returns ``(guess_l, ok)``.  Public so
    callers running the consecutive protocol as SEPARATE compiled pass
    programs (one jit per pass — the single fused program costs several
    hundred seconds of XLA compile at flagship scale) reproduce the
    library glue exactly."""
    guess_l, _, seed_ok = ortho_cd(evec_r)
    return guess_l, seed_ok


def _consecutive_result(out_r, out_l, seed_ok, options: SolverOptions):
    n_max = options.n_max
    targ = jnp.arange(n_max) < options.n_targ
    # |eig_r - eig_l|: the reference's signed maxval (diaglib.f90:2887)
    # would pass a left pass that converged to LOWER values; intent-level
    # fix per DESIGN.md policy
    eig_match = (jnp.max(jnp.where(targ, jnp.abs(out_r.eig - out_l.eig), 0.0))
                 <= options.tol)
    ok = out_r.ok & out_l.ok & eig_match
    # Final biorthonormalization.  The reference calls svd_biortho here
    # (diaglib.f90:2908-2914), but the overlap of *converged* eigenpairs is
    # already near +/-identity, so its singular values are degenerate and the
    # SVD rotates arbitrarily inside the cluster — scrambling the
    # eigenvalue<->vector pairing.  The pairing-preserving equivalent is a
    # solve: evec_l <- O^{-1} evec_l gives evec_l @ evec_r^T = I exactly
    # while perturbing each vector only at the size of its residual.
    # (QR-based solve of the small f64 overlap)
    overlap = mmT(out_l.evec, out_r.evec)
    q, r_ = jnp.linalg.qr(overlap)
    evec_l = jax.scipy.linalg.solve_triangular(
        r_, mTm(q, out_l.evec), lower=False)
    evec_r = out_r.evec

    return NonsymResult(
        eig=out_l.eig - options.shift,
        evec_r=evec_r, evec_l=evec_l, ok=ok,
        n_iter=out_r.it + out_l.it,
        n_matvec=out_r.n_matvec + out_l.n_matvec,
        done=out_l.done,
        rms_history_r=out_r.rms_h, max_history_r=out_r.max_h,
        rms_history_l=out_l.rms_h, max_history_l=out_l.max_h,
        eig_history=out_l.eig_h,
        ortho_ok=out_r.ortho_ok & seed_ok & out_l.ortho_ok,
    )


class NonsymPassResult(NamedTuple):
    """Public result of ONE one-sided pass (:func:`nonsym_pass`)."""

    eig: jax.Array
    evec: jax.Array
    ok: jax.Array
    n_iter: jax.Array
    n_matvec: jax.Array
    done: jax.Array
    rms_h: jax.Array
    max_h: jax.Array
    eig_h: jax.Array
    ortho_ok: jax.Array


def nonsym_pass(matvec, precnd, evec_guess, options: SolverOptions, *,
                use_left=False, key=None, sharding=None,
                driver: str = "auto"):
    """One one-sided Davidson pass as a PUBLIC building block.

    ``matvec`` is the operator of THIS side (A for right, A^T for left).
    ``use_left`` may be a plain bool (a dedicated program per side) or a
    TRACED boolean scalar — then ONE compiled program serves both sides,
    with the caller feeding the side's operator data and the flag as
    inputs.  At flagship scale the fused consecutive+ladder program costs
    several hundred seconds of XLA compile; running the protocol as
    separately-jitted pass programs (this function) with
    :func:`nonsym_seed_left` / :func:`nonsym_finalize` as the glue
    reproduces ``nonsym_ladder`` semantics at a fraction of the compile
    cost.  Returns a :class:`NonsymPassResult` (``eig`` has
    ``options.shift`` removed).
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    out = _nonsym_pass(matvec, precnd, jnp.asarray(evec_guess), options,
                       use_left=use_left, key=key, sharding=sharding,
                       driver=driver)
    return NonsymPassResult(
        eig=out.eig - options.shift, evec=out.evec, ok=out.ok,
        n_iter=out.it, n_matvec=out.n_matvec, done=out.done,
        rms_h=out.rms_h, max_h=out.max_h, eig_h=out.eig_h,
        ortho_ok=out.ortho_ok)


def nonsym_finalize(res_r: NonsymPassResult, res_l: NonsymPassResult,
                    options: SolverOptions, seed_ok=None):
    """Consecutive-mode finalize over two one-sided pass results
    (``use_left=False`` then ``use_left=True`` seeded via
    :func:`nonsym_seed_left`): eigenvalue cross-check + pairing-preserving
    biorthonormalization — the same glue ``nonsym(side='c')`` applies
    internally.  ``seed_ok`` (from :func:`nonsym_seed_left`) is ANDed into
    ``ortho_ok`` when given."""

    class _P:  # pass-state view of the public result (eig re-shifted)
        def __init__(self, res):
            self.eig = res.eig + options.shift
            self.evec = res.evec
            self.ok = res.ok
            self.it = res.n_iter
            self.n_matvec = res.n_matvec
            self.done = res.done
            self.rms_h = res.rms_h
            self.max_h = res.max_h
            self.eig_h = res.eig_h
            self.ortho_ok = res.ortho_ok

    ok0 = jnp.asarray(True) if seed_ok is None else seed_ok
    return _consecutive_result(_P(res_r), _P(res_l), ok0, options)
