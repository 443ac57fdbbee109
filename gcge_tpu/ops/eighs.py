"""Symmetric eigensolvers for the projected (Rayleigh-Ritz) problems.

* :func:`safe_eigh` — ``jnp.linalg.eigh`` (cuSOLVER on the GPU) with a
  NaN-recovery retry; the default behind :func:`eigh`.
* :func:`eigh_jacobi` — a device eigh as warm start plus a few sweeps of
  cyclic Jacobi, each sweep m-1 rounds of m/2 disjoint Givens rotations.
  Jacobi converges quadratically, so 2 sweeps drive the eigen-residual
  ``||H u - u w||`` to rounding level even from a warm start whose
  backtransform is only f32-accurate.
* :func:`eigh_newton` — the same polish at O(m^3) per step for large m
  (Newton eigenvector refinement plus batched rotations of near-degenerate
  clusters), optionally partitioned over a device mesh.

This replaces the reference's MPI spectrum-sliced ``dsyevx``
(reference ``src/ops_eig_sol_gcg.c:1084-1189``), and everything here
stays inside fused device programs — no host sync.
"""

from __future__ import annotations

import os
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np


def safe_eigh(h):
    """``jnp.linalg.eigh`` with a NaN-recovery retry.

    A device eigh can return all-NaN for finite symmetric matrices whose
    eigenvalue spread reaches the rounding floor (rank-deficient B-Grams
    with eigenvalues 1e-13..2 — rank deflation territory, exactly where
    GCG/PAS operate near convergence).  On NaN, retry with a Tikhonov shift
    (same eigenvectors) and subtract the shift from the eigenvalues — exact
    up to rounding, and the shifted spectrum clears the failure region.
    """
    m = h.shape[0]
    scale = jnp.max(jnp.abs(jnp.diagonal(h))) + jnp.asarray(1e-300, h.dtype)

    def attempt(rel_reg):
        reg = jnp.asarray(rel_reg, h.dtype) * scale
        w, u = jnp.linalg.eigh(h + reg * jnp.eye(m, dtype=h.dtype))
        return w - reg, u

    def is_bad(w, u):
        return jnp.any(jnp.isnan(w)) | jnp.any(jnp.isnan(u))

    # The failure region depends on the matrix (observed Grams needing
    # shifts between 1e-12 and 1e-11 of scale), so the base call is ALWAYS
    # shifted by 1e-10*scale — the subtraction restores eigenvalues to
    # ~eps*reg absolute error, far below the deflation floors that consume
    # these spectra — with a single conditional escalation to 1e-7.
    w0, u0 = attempt(1e-10)
    return jax.lax.cond(is_bad(w0, u0), lambda _: attempt(1e-7),
                        lambda _: (w0, u0), None)


@lru_cache(maxsize=None)
def _round_robin_rounds(m: int):
    """Round-robin pairings: m-1 rounds of m/2 disjoint pairs covering all
    index pairs once (circle method).  m must be even.  Returns a tuple of
    (p, q) numpy index arrays per round."""
    assert m % 2 == 0
    players = list(range(m))
    rounds = []
    for _ in range(m - 1):
        p = np.asarray([players[i] for i in range(m // 2)], np.int32)
        q = np.asarray([players[m - 1 - i] for i in range(m // 2)], np.int32)
        lo = np.minimum(p, q)
        hi = np.maximum(p, q)
        rounds.append((lo, hi))
        players = [players[0]] + [players[-1]] + players[1:-1]
    return tuple(rounds)


def _jacobi_round(h, v, p, q):
    """Apply m/2 disjoint Jacobi rotations zeroing H[p, q] (one round)."""
    m = h.shape[0]
    app = h[p, p]
    aqq = h[q, q]
    apq = h[p, q]
    # stable 2x2 symmetric Schur (Golub & Van Loan): H'[p,q] = 0
    small = jnp.abs(apq) <= 1e-300
    apq_safe = jnp.where(small, 1.0, apq)
    tau = (aqq - app) / (2.0 * apq_safe)
    # |tau| huge: t = 1/(2 tau) to relative accuracy 1/(4 tau^2) < 1e-14.
    # Computing sqrt(1 + tau^2) there could overflow, so the stable branch
    # must see a clipped tau.
    big = jnp.abs(tau) > 1e7
    tau_c = jnp.clip(tau, -1e7, 1e7)
    t_stable = jnp.sign(tau_c) / (jnp.abs(tau_c) + jnp.sqrt(1.0 + tau_c * tau_c))
    t = jnp.where(big, 0.5 / jnp.where(big, tau, 1.0), t_stable)
    t = jnp.where(tau == 0.0, 1.0, t)  # tau=0 -> t=1 (45 deg)
    t = jnp.where(small, 0.0, t)
    c = 1.0 / jnp.sqrt(1.0 + t * t)
    s = t * c
    # assemble the block rotation J = I with J[pp]=c J[qq]=c J[pq]=s J[qp]=-s
    j = jnp.eye(m, dtype=h.dtype)
    j = j.at[p, p].set(c).at[q, q].set(c).at[p, q].set(s).at[q, p].set(-s)
    h = j.T @ h @ j
    v = v @ j
    return h, v


def _schur_cs(app, aqq, apq, dtype):
    """Stable 2x2 symmetric Schur rotation (vectors in, (c, s) out); the
    same guarded algebra as :func:`_jacobi_round`."""
    small = jnp.abs(apq) <= 1e-300
    apq_safe = jnp.where(small, 1.0, apq)
    tau = (aqq - app) / (2.0 * apq_safe)
    big = jnp.abs(tau) > 1e7
    tau_c = jnp.clip(tau, -1e7, 1e7)
    t_stable = jnp.sign(tau_c) / (jnp.abs(tau_c) + jnp.sqrt(1.0 + tau_c * tau_c))
    t = jnp.where(big, 0.5 / jnp.where(big, tau, 1.0), t_stable)
    t = jnp.where(tau == 0.0, 1.0, t)
    t = jnp.where(small, 0.0, t)
    c = 1.0 / jnp.sqrt(1.0 + t * t)
    s = t * c
    return c, s


def _jacobi_round_systolic(h, v, sigma):
    """One round-robin round of me/2 disjoint rotations, scatter-free.

    Position pairs are ALWAYS (i, me-1-i); the circle-method player
    rotation is realized by permuting h/v by the fixed ``sigma`` after the
    rotations, so a full sweep = (me-1) identical iterations (fori-able).
    All ops are diagonals, flips, row/column-block axpys and one static
    permutation — unlike a full (me, me) rotation matrix built by 4
    scatters and applied by two matmuls per round, this one avoids every
    scatter and matmul."""
    me = h.shape[0]
    m2 = me // 2
    d = jnp.diagonal(h)
    apq = jnp.diagonal(jnp.flip(h, 1))[:m2]       # h[i, me-1-i]
    c, s = _schur_cs(d[:m2], jnp.flip(d[m2:]), apq, h.dtype)
    # rows: (J^T h)[p] = c h[p] - s h[q]; (J^T h)[q] = s h[p] + c h[q]
    top = h[:m2]
    botf = jnp.flip(h[m2:], 0)                    # row i = h[me-1-i]
    ntop = c[:, None] * top - s[:, None] * botf
    nbot = s[:, None] * top + c[:, None] * botf
    h = jnp.concatenate([ntop, jnp.flip(nbot, 0)], axis=0)
    # cols: (X J)[:, p] = c X[:, p] - s X[:, q]; (X J)[:, q] = s X[:, p] + c X[:, q]
    left = h[:, :m2]
    rightf = jnp.flip(h[:, m2:], 1)
    nleft = c[None, :] * left - s[None, :] * rightf
    nright = s[None, :] * left + c[None, :] * rightf
    h = jnp.concatenate([nleft, jnp.flip(nright, 1)], axis=1)
    vl = v[:, :m2]
    vrf = jnp.flip(v[:, m2:], 1)
    nvl = c[None, :] * vl - s[None, :] * vrf
    nvr = s[None, :] * vl + c[None, :] * vrf
    v = jnp.concatenate([nvl, jnp.flip(nvr, 1)], axis=1)
    # circle-method rotation of the players = fixed permutation
    h = jnp.take(jnp.take(h, sigma, axis=0), sigma, axis=1)
    v = jnp.take(v, sigma, axis=1)
    return h, v


@partial(jax.jit, static_argnames=("sweeps",))
def jacobi_polish(h, w0, u0, sweeps: int = 3):
    """Polish an approximate eigendecomposition ``(w0, u0)`` of symmetric h.

    Returns ``(w, u)`` ascending, with ``u`` orthonormal and the residual
    ``||H u - u w||`` at the accuracy of short-contraction matmuls.  Sweeps
    stop early once the off-diagonal
    norm hits the rounding floor — the typical warm-started call pays for
    ONE sweep; clustered spectra take two (``sweeps`` is the cap)."""
    m = h.shape[0]
    h1 = u0.T @ (h @ u0)
    h1 = 0.5 * (h1 + h1.T)
    me = m + (m % 2)
    if me != m:
        # decoupled dummy slot: zero coupling -> identity rotations
        h1 = jnp.pad(h1, ((0, 1), (0, 1)))
    v = jnp.eye(me, dtype=h.dtype)
    # circle method as a position permutation: new[0]=old[0],
    # new[1]=old[me-1], new[k]=old[k-1]; order me-1, so a full sweep
    # restores the original ordering
    sigma = jnp.asarray(np.r_[0, me - 1, np.arange(1, me - 1)], np.int32)
    n_rounds = me - 1
    scale = jnp.maximum(jnp.max(jnp.abs(h1)), jnp.asarray(1e-300, h.dtype))
    off_tol = jnp.asarray(1e-13, h.dtype) * scale

    def off_norm(h1):
        off = h1 - jnp.diag(jnp.diagonal(h1))
        return jnp.max(jnp.abs(off))

    def one_sweep(st):
        h1, v, k = st

        def body(i, st2):
            h1, v = st2
            return _jacobi_round_systolic(h1, v, sigma)

        h1, v = jax.lax.fori_loop(0, n_rounds, body, (h1, v))
        return h1, v, k + 1

    def cond(st):
        h1, v, k = st
        return (k < sweeps) & (off_norm(h1) > off_tol)

    h1, v, _ = jax.lax.while_loop(cond, one_sweep, (h1, v, jnp.int32(0)))
    w = jnp.diagonal(h1)[:m]
    v = v[:m, :m] if me != m else v
    order = jnp.argsort(w)
    w = jnp.take(w, order)
    u = (u0 @ v)[:, order]
    return w, u


@partial(jax.jit, static_argnames=("sweeps",))
def eigh_jacobi(h, sweeps: int = 2):
    """Device-accurate ``eigh``: fast device eigh warm start + Jacobi polish."""
    w0, u0 = safe_eigh(h)
    return jacobi_polish(h, w0, u0, sweeps=sweeps)


# --------------------------------------------------------------------------
# Large-m eigh: Newton eigenvector refinement + batched cluster rotations.
#
# The Jacobi polish above costs ~4*m^4 flops per sweep (m-1 rounds of m x m
# matmul pairs) — fine for the m <= few-hundred projected problems of typical
# GCG runs, but the reference sweeps nev up to 5000 (test/submit.sh:30-32),
# i.e. projected matrices of order ~10k+2bs, where a sweep would cost 4e16
# flops.  eigh_newton replaces the sweeps with first-order eigenvector
# refinement: given the warm start U from the device eigh, H1 = U^T H U is
# nearly diagonal, and the Newton/perturbation correction
#     U <- orth(U (I + E)),   E[j,i] = H1[j,i] / (d_i - d_j)   (i != j)
# contracts the off-diagonal quadratically (off^2/gap per step) at O(m^3)
# matmul cost per step.  Pairs with |d_i - d_j| <= theta*scale are excluded
# (their corrections would amplify the warm start's noise) and handled by a
# second stage: contiguous runs of near-equal eigenvalues (ascending warm
# start) are gathered into <=cap-sized blocks, the per-block MEAN is
# subtracted (so the batched device eigh's backtransform error scales with
# the cluster WIDTH, not ||H||), the blocks are eigensolved +
# Jacobi-polished batched, and the block rotations are scattered back into a
# block-diagonal m x m rotation.  Clusters with more than `cap` members are
# split (the leftover cross-split coupling is bounded by the intra-cluster
# gap, i.e. theta*scale-level eigen-residual — only truly >cap-fold
# degenerate spectra hit this; raise `cap` there).
# --------------------------------------------------------------------------


def _acc_matmul_sym(h, u):
    """Accurate h @ u for SYMMETRIC h (chunked contraction, see ops.multivec)."""
    from gcge_tpu.ops.multivec import gram

    return gram(h, u)


# above this m eigh_newton's 'auto' warm start is the f32 device eigh (with
# more refinement passes) instead of the f64 one
F32_WARM_MIN_M = 768
# experiment override (huge-nev A/Bs)
if os.environ.get("GCGE_F32_WARM_MIN_M"):
    F32_WARM_MIN_M = int(os.environ["GCGE_F32_WARM_MIN_M"])


@partial(jax.jit, static_argnames=("iters", "cap", "nblk", "polish_sweeps",
                                   "warm_dtype", "passes", "mesh",
                                   "cluster_first", "out"))
def eigh_newton(h, iters: int = 4, theta: float | None = None, cap: int = 64,
                nblk: int | None = None, polish_sweeps: int = 4, warm=None,
                warm_dtype: str = "auto", passes: int | None = None,
                mesh=None, cluster_first: bool | None = None,
                out: str = "replicated", warm_h1=None):
    """Eigendecomposition of symmetric ``h`` for large m (ascending).

    Accurate like :func:`eigh_jacobi` but at O(m^3) per refinement step
    instead of O(m^4) per sweep; intended for
    projected matrices beyond a few hundred rows (huge-nev Rayleigh-Ritz).

    Each PASS runs two stages:

    1. masked Newton refinement — ``U <- orth(U (I + E))`` with
       ``E = H1 / (d_i - d_j)`` applied only to pairs whose gap exceeds
       ``gap_tol = 8 * off0`` (``off0`` = the pass's entry coupling), so
       every correction satisfies ``|E| <= 1/8`` and contracts
       quadratically;
    2. batched cluster rotations — contiguous runs of eigenvalues closer
       than ``gap_tol`` are gathered into <=``cap``-sized blocks, the block
       MEAN is subtracted (the batched device eigh's error then scales with
       the cluster WIDTH, not ||H||), and the mean-shifted blocks are
       eigensolved + Jacobi-polished batched, exactly diagonalizing what
       stage 1 had to skip.

    With an f64-quality warm start one pass reaches ~1e-11 residuals.
    ``warm_dtype='auto'`` switches to the F32 device eigh past
    :data:`F32_WARM_MIN_M` and runs
    MORE passes: each pass shrinks the coupling scale by orders of
    magnitude, so the adaptive ``gap_tol`` tightens geometrically and the
    cluster chains shorten until only true degeneracies remain.

    ``theta`` overrides the adaptive per-pass gap_tol (relative to
    ``max|eigenvalue|``); ``nblk`` is the static budget of multi-member
    cluster blocks (default m//2 capped at 64); ``warm`` is an optional
    ``(w0, u0)`` warm start standing in for the device eigh (tests use it
    to reproduce a noisy warm start on exact-f64 hosts).

    ``mesh``: optional ``jax.sharding.Mesh``.  When given, the O(m^3) work is
    *partitioned over the mesh devices* instead of redundantly replicated:
    the eigenvector-matrix columns are sharded over the mesh's first axis for
    every refinement GEMM, and the batched cluster eighs are sharded over the
    block dimension.  This is the analogue of the reference's MPI
    spectrum-sliced ``dsyevx`` — there each rank eigensolved an ``IL..IU``
    index slice and ranks stitched results with ``MPI_Allgatherv``
    (``ops_eig_sol_gcg.c:1084-1189``, splitter ``ops.c:201-256``); here each
    device refines a column slice / a slice of the cluster blocks and XLA's
    partitioner inserts the all-gathers.  Like the reference's, the result is
    bit-identical on every device.

    Under a mesh the m x m factors (``h``, ``h1``, ``u``, the rotations) are
    also column-sharded in MEMORY, so the per-device resident footprint is
    ~m^2/n_devices instead of m^2 — the enabler for nev >= ~5000 runs where
    a replicated projected matrix alone is ~GBs.  Transients still peak at one gathered operand per GEMM
    (XLA's all-gather-matmul); the warm-start device eigh gathers its input
    once.  ``out`` controls the RESULT placement: ``'replicated'`` (default,
    both ``w`` and ``u`` all-gathered — the drop-in contract) or ``'cols'``
    (``u`` left column-sharded; ``w`` is always replicated).
    """
    from gcge_tpu.ops.multivec import gram

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as _P

        _ax = mesh.axis_names[0]

        def _cols(x):   # shard the trailing (column) axis of an m x m factor
            return jax.lax.with_sharding_constraint(
                x, NamedSharding(mesh, _P(None, _ax)))

        def _blks(x):   # shard a batched (nblk, c, c) stack over blocks
            return jax.lax.with_sharding_constraint(
                x, NamedSharding(mesh, _P(_ax, None, None)))

        def _repl(x):   # force a replicated (all-gathered) small result
            return jax.lax.with_sharding_constraint(
                x, NamedSharding(mesh, _P()))
    else:
        _cols = _blks = _repl = lambda x: x

    m = h.shape[0]
    h = _cols(h)        # resident h is column-sharded under a mesh
    if nblk is None:
        nblk = max(1, min(m // 2, 64))
    use_f32_warm = warm is None and (
        warm_dtype == "f32" or (warm_dtype == "auto" and m >= F32_WARM_MIN_M))
    if passes is None:
        # GCGE_NEWTON_PASSES: experiment override (huge-nev RR-quality A/Bs)
        passes = int(os.environ.get("GCGE_NEWTON_PASSES", "0")) or (
            3 if use_f32_warm else 1)
    if warm is not None:
        w0, u = warm
    elif use_f32_warm:
        # HIGHEST: any f32 product on the way stays full f32, never TF32
        with jax.default_matmul_precision("highest"):
            w32, u32 = safe_eigh(h.astype(jnp.float32))
        w0, u = w32.astype(h.dtype), u32.astype(h.dtype)
    else:
        w0, u = safe_eigh(h)
    u = _cols(u)
    scale = jnp.maximum(jnp.max(jnp.abs(w0)), jnp.asarray(1e-300, h.dtype))
    eye = jnp.eye(m, dtype=h.dtype)
    offmask = 1.0 - eye
    eps = float(jnp.finfo(h.dtype).eps)
    # Two stopping floors for the Newton refinement, chosen per pass:
    # * FIRST pass: 32*eps*scale.  GCG needs the Rayleigh-Ritz basis at this
    #   quality — raising it to 1024*eps measurably stalls the nev=200
    #   production solve (pairs floor right at the 1e-8 relative test).
    #   The refine loop CAN reach ~10*eps*scale: within the loop the
    #   Newton-Schulz step keeps repairing u with accurate Grams.
    # * RE-ENTRANT passes (multi-pass coarse warm starts): 1024*eps*scale.
    #   Rebuilding h1 from scratch between passes (cluster rotations are
    #   plain GEMMs) leaves ~200*eps*scale of off-diagonal
    #   noise even for an exact eigenbasis (measured 1.05e-12 at scale
    #   21.8).  A re-entrant pass below that floor "refines" pure noise:
    #   gap_tol collapses to the noise scale, E = noise/noise-gaps becomes
    #   an O(0.1)-norm random rotation, and ONE such step costs 4 decades
    #   (observed: 9.9e-14 -> 5.5e-8 orthonormality on a production RR
    #   matrix).  1024*eps gives ~5x margin over the measured noise.
    off_floor_first = jnp.asarray(32.0 * eps, h.dtype) * scale
    off_floor_reent = jnp.asarray(1024.0 * eps, h.dtype) * scale

    def h1_of(u):
        h1 = gram(u, _acc_matmul_sym(h, _cols(u)))
        return _cols(0.5 * (h1 + h1.T))

    def gap_tol_of(h1):
        if theta is not None:
            return jnp.asarray(theta, h.dtype) * scale
        off0 = jnp.max(jnp.abs(h1 * offmask))
        return jnp.maximum(8.0 * off0, (64.0 * eps) * scale)

    def refine(u, h1, off_floor):
        """Masked Newton refinement (stage 1).

        Returns the BEST state seen, not the last: on spectra with wide
        near-degenerate runs the iteration is a repeller — the second-order
        error terms scale with the run WIDTH while the corrections scale
        with the (much smaller) gap, so a step can grow the coupling by
        orders of magnitude (measured: 2.4e-8 -> 4.6e-5 in two steps on a
        100-wide 1e-6-spaced run).  The divergence guard stops the loop,
        and the best-state rollback discards the damaged iterates; the
        stall-escalation stage below then closes the run with a wide block
        eigh."""
        gap_tol = gap_tol_of(h1)

        def masked_off(h1):
            d = jnp.diagonal(h1)
            delta = d[None, :] - d[:, None]
            mask = jnp.abs(delta) > gap_tol
            return jnp.max(jnp.abs(jnp.where(mask, h1, 0.0)))

        def step(st):
            u, h1, k, _, bu, bh1, boff = st
            off = masked_off(h1)
            better = off < boff
            bu = jnp.where(better, u, bu)
            bh1 = jnp.where(better, h1, bh1)
            boff = jnp.minimum(off, boff)
            d = jnp.diagonal(h1)
            delta = d[None, :] - d[:, None]      # delta[j, i] = d_i - d_j
            mask = jnp.abs(delta) > gap_tol
            e = jnp.where(mask, h1 / jnp.where(mask, delta, 1.0), 0.0)
            # trust cap on the WHOLE correction: the per-entry bound
            # |E| <= 1/8 does not bound ||E||_2 when many pairs sit just
            # past gap_tol, and u(I + E) with a large E runs away faster
            # than one Newton-Schulz step can re-orthonormalize (observed:
            # a coarse f32 warm start on a 6e-3-spaced spectrum diverged to
            # 1e49).  ||E||_2 <= sqrt(||E||_1 ||E||_inf) is two reductions.
            e_2 = jnp.sqrt(jnp.max(jnp.sum(jnp.abs(e), 0)) *
                           jnp.max(jnp.sum(jnp.abs(e), 1)))
            e = e * jnp.minimum(1.0, 0.25 / jnp.maximum(e_2, 1e-300))
            u = _cols(u) @ (eye + e)
            # one Newton-Schulz orthonormality step (I + E is orthogonal
            # to first order; this removes the second-order drift)
            g = _cols(gram(u, u))
            u = _cols(_cols(u) @ (1.5 * eye - 0.5 * g))
            return u, h1_of(u), k + 1, off, bu, bh1, boff

        off_entry = masked_off(h1)

        def keep_going(st):
            _, h1, k, _, _, _, _ = st
            off = masked_off(h1)
            # divergence guard: large near-gap_tol clusters make the
            # iteration a repeller (each step amplifies the masked coupling
            # by ~cluster_len/8 through second-order cross terms with the
            # intra-cluster coupling refine cannot touch).  Mild growth is
            # fine — the bulk of the pairs still contract and the cluster
            # stage mops up — but runaway (>8x the pass entry coupling)
            # means every further step is destructive: stop and hand off.
            return (k < iters) & (off > off_floor) & (off < 8.0 * off_entry)

        u, h1, _, _, bu, bh1, boff = jax.lax.while_loop(
            keep_going, step,
            (u, h1, jnp.int32(0), jnp.full((), jnp.inf, h.dtype),
             u, h1, jnp.full((), jnp.inf, h.dtype)))
        off_fin = masked_off(h1)
        worse = off_fin > boff
        u = jnp.where(worse, bu, u)
        h1 = jnp.where(worse, bh1, h1)
        return u, h1, gap_tol

    def cluster_rotate(u, h1, gap_tol, phase=0, c=None, nblk_=None,
                       min_len=2, by_len=False):
        """Batched mean-shifted block eighs on near-degenerate runs
        (stage 2).  Returns the rotated ``(u, w)``.

        ``phase`` offsets the cap-split boundaries of over-cap runs (split
        at ``pos0 % c == phase`` instead of 0); ``c``/``nblk_`` override the
        block size and block budget (the over-cap fix-up below re-runs this
        stage with blocks wide enough to hold a whole run).  ``min_len``
        restricts block selection to segments with at least that many
        members; ``by_len`` orders the selected blocks by DESCENDING segment
        length instead of by index — the fix-up uses both so its limited
        block budget lands on the over-cap runs rather than on whichever
        already-resolved tight clusters happen to come first in the
        spectrum."""
        d = jnp.diagonal(h1)
        if c is None:
            c = cap
        if nblk_ is None:
            nblk_ = nblk
        idx = jnp.arange(m)
        gaps = jnp.concatenate([jnp.ones((1,), h.dtype) * (2 * gap_tol),
                                d[1:] - d[:-1]])
        b0 = gaps > gap_tol                               # cluster starts
        start0 = jax.lax.cummax(jnp.where(b0, idx, 0))
        pos0 = idx - start0
        b = b0 | (pos0 % c == phase)                      # split at cap
        seg = jnp.cumsum(b.astype(jnp.int32)) - 1         # segment ids
        ones = jnp.ones((m,), jnp.int32)
        seg_len = jax.ops.segment_sum(ones, seg, num_segments=m)
        len_at = jnp.take(seg_len, seg)
        multi_start = b & (len_at >= max(2, min_len))
        if by_len:
            pri = jnp.where(multi_start, len_at, 0)
            cand = jnp.argsort(-pri)[:nblk_]
            starts = jnp.where(jnp.take(pri, cand) > 0, cand, m)
        else:
            starts = jnp.nonzero(multi_start, size=nblk_, fill_value=m)[0]
        valid_blk = starts < m
        lens = jnp.where(
            valid_blk,
            jnp.take(seg_len, jnp.take(seg, jnp.minimum(starts, m - 1))), 0)
        rows = jnp.clip(starts[:, None] + jnp.arange(c)[None, :], 0, m - 1)
        in_blk = (jnp.arange(c)[None, :] < lens[:, None]) & valid_blk[:, None]
        sub = h1[rows[:, :, None], rows[:, None, :]]      # (nblk, c, c)
        mvalid = in_blk[:, :, None] & in_blk[:, None, :]
        sub = jnp.where(mvalid, sub, 0.0)
        fin = in_blk.astype(h.dtype)
        mu = jnp.sum(sub * jnp.eye(c, dtype=h.dtype), axis=(1, 2)) / \
            jnp.maximum(jnp.sum(fin, axis=1), 1.0)
        # subtract the block mean (valid diag only); give padded slots
        # distinct, well-separated diagonal values above the block norm so
        # they decouple
        blk_norm = jnp.max(jnp.abs(sub), axis=(1, 2)) + gap_tol * c
        pad_diag = (jnp.arange(c, dtype=h.dtype) + 2.0)[None, :] * \
            (2.0 * blk_norm)[:, None]
        diag_new = jnp.where(in_blk, -mu[:, None], pad_diag)
        sub = _blks(sub + diag_new[:, :, None] * jnp.eye(c, dtype=h.dtype))
        wb0, vb0 = jax.vmap(safe_eigh)(sub)
        wb, vb = jax.vmap(
            lambda hh, ww, uu: jacobi_polish(hh, ww, uu, sweeps=polish_sweeps)
        )(sub, wb0, vb0)
        wb, vb = _repl(wb), _repl(vb)
        # scatter block rotations into a block-diagonal m x m rotation
        s_rot = jnp.zeros((m, m), h.dtype).at[
            rows[:, :, None], rows[:, None, :]].add(
            jnp.where(mvalid, vb, 0.0), mode="drop")
        covered = jnp.zeros((m,), jnp.int32).at[rows].add(
            in_blk.astype(jnp.int32), mode="drop") > 0
        s_rot = _cols(
            s_rot + jnp.diag(jnp.where(covered, 0.0, 1.0).astype(h.dtype)))
        u = _cols(_cols(u) @ s_rot)
        w = jnp.where(covered, 0.0, d)
        w = w.at[rows].add(jnp.where(in_blk, wb + mu[:, None], 0.0),
                           mode="drop")
        return u, w

    if out not in ("replicated", "cols"):
        raise ValueError(f"out must be 'replicated' or 'cols', got {out!r}")
    if passes < 1:
        raise ValueError(f"eigh_newton needs passes >= 1, got {passes}")
    if warm_h1 is not None and warm is None:
        raise ValueError("warm_h1 requires warm")

    # ``warm_h1``: the caller can supply u0^T h u0 analytically when the
    # warm start's structure makes it exact (GCG's Rayleigh-Ritz block
    # warm start does) — skipping the O(m^3) entry Gram.
    h1 = _cols(warm_h1) if warm_h1 is not None else h1_of(u)
    w = jnp.diagonal(h1)
    gap_tol = gap_tol_of(h1)
    if cluster_first is None:
        # coarse warm starts only: with an f64-quality warm start gap_tol
        # sits far below the spacing (singleton clusters) and the extra
        # stage would be pure cost
        cluster_first = use_f32_warm or warm is not None
    if cluster_first:
        # cluster-FIRST for coarse warm starts: with f32-level coupling,
        # gap_tol lands at the eigenvalue-spacing scale and clusters grow to
        # dozens of members; the Newton stage then AMPLIFIES the masked
        # coupling by ~cluster_len/8 per step (second-order cross terms with
        # the intra-cluster coupling it cannot touch) — a repeller, observed
        # diverging to 1e49 on a production Rayleigh-Ritz matrix.  One
        # cluster pass up front exactly diagonalizes those blocks, dropping
        # the intra-cluster coupling to the batched-eigh floor; every
        # subsequent refine sees singleton-scale clusters and contracts
        # quadratically as designed.  (f64-quality warm starts skip this:
        # their gap_tol sits far below the spacing, so clusters are already
        # singletons and the extra stage would be pure cost.)
        u, w = cluster_rotate(u, h1, gap_tol_of(h1))
        h1 = h1_of(u)
    for p in range(passes):
        u, h1, gap_tol = refine(
            u, h1, off_floor_first if p == 0 else off_floor_reent)
        u, w = cluster_rotate(u, h1, gap_tol)
        if p + 1 < passes:
            h1 = h1_of(u)

    # ------------------------------------------------------------------
    # Stall-escalation closing stage.  Two distinct failure modes leave the
    # main passes with coupling above the floor, and both are closed by the
    # same move:
    #
    # * an over-cap near-degenerate run was SPLIT at the ``cap`` boundary —
    #   the batched eighs cannot remove cross-split coupling (each block
    #   eigh is an arbitrary re-scramble of a degenerate subspace; per-block
    #   rotations conserve cross-block mass — staggered/tournament sweeps
    #   measured to stall at ~0.5x entry coupling after 24 sweeps);
    # * the Newton refinement hit its repeller on a run WIDER than its gaps
    #   (second-order terms scale with run width, not gap) and rolled back,
    #   leaving the run's coupling untouched, with the adaptive gap_tol too
    #   SMALL to even see the run as a cluster (measured: 100-wide
    #   1e-6-spaced run, warm coupling 2.4e-8 -> gap_tol 1.9e-7 -> no
    #   cluster detected, 2e-4 eigenvalue plateau).
    #
    # The closing move: while the total coupling sits above the re-entrant
    # floor, ESCALATE the gap tolerance (x32 per round), gather the widest
    # near-degenerate runs into blocks wide enough to hold them whole
    # (c = min(512, m), below F32_WARM_MIN_M), exactly diagonalize, then
    # re-refine at the re-entrant floor.  Runs wider than 512 keep the
    # width-scale plateau (documented limitation — raise `cap`/use more
    # devices there); the progress guard stops the loop when an iteration
    # fails to shrink the coupling.  The common path pays one stale-h1
    # check; the body runs only when taken (lax.cond).
    c2 = min(512, m)
    nblk2 = max(1, min(8, m // 2))

    def _tot_off(h1c):
        return jnp.max(jnp.abs(h1c * offmask))

    def _closing(args):
        u, w = args

        def body(st):
            u, w, h1c, gt_prev, _, k = st
            gt = jnp.maximum(gap_tol_of(h1c), 32.0 * gt_prev)
            off_before = _tot_off(h1c)
            # widest runs first (by_len): tight already-resolved clusters
            # the escalated tolerance re-qualifies cannot starve the
            # offending runs of the block budget
            u, w = cluster_rotate(u, h1c, gt, c=c2, nblk_=nblk2,
                                  by_len=True)
            u, h1c, _ = refine(u, h1_of(u), off_floor_reent)
            w = jnp.diagonal(h1c)
            return u, w, h1c, gt, off_before, k + 1

        def cond_f(st):
            _, _, h1c, gt_prev, off_prev, k = st
            off = _tot_off(h1c)
            return (k < 3) & (off > off_floor_reent) & \
                (off < 0.5 * off_prev) & (gt_prev < scale)

        u, w, _, _, _, _ = jax.lax.while_loop(
            cond_f, body,
            (u, w, h1_of(u), gap_tol, jnp.full((), jnp.inf, h.dtype),
             jnp.int32(0)))
        return u, w

    # stale-h1 trigger: h1 predates the final cluster_rotate.  A block
    # rotation removes intra-block coupling but can CONCENTRATE row mass
    # into couplings between rotated and outside columns (up to ~sqrt(cap)x
    # the pre-rotation max), so the stale read can sit below the floor while
    # the fresh coupling is above it.  Widening the trigger by sqrt(c2)
    # makes it a true overestimate again; a false positive costs one fresh
    # Gram inside _closing (whose cond checks fresh coupling and exits).
    u, w = jax.lax.cond(
        _tot_off(h1) * np.sqrt(float(c2)) > off_floor_reent,
        _closing, lambda a: a, (u, w))

    order = jnp.argsort(w)
    u_out = jnp.take(u, order, axis=1)
    u_out = _cols(u_out) if out == "cols" else _repl(u_out)
    return _repl(jnp.take(w, order)), u_out


# m above which the Newton refinement is preferred over Jacobi sweeps: a
# Jacobi sweep is ~4m^4 matmul flops (m-1 rounds) vs ~10m^3 per Newton step.
NEWTON_MIN_M = 256


def _host_eigh(h):
    """eigh via pure_callback to host LAPACK (full f64, one host round trip
    per call)."""
    m = h.shape[0]

    def cb(hm):
        w, c = np.linalg.eigh(hm)
        return w.astype(hm.dtype), c.astype(hm.dtype)

    return jax.pure_callback(
        cb,
        (jax.ShapeDtypeStruct((m,), h.dtype), jax.ShapeDtypeStruct((m, m), h.dtype)),
        h,
        vmap_method="sequential",
    )


def eigh(h, backend: str = "auto", mesh=None, warm=None, warm_h1=None,
         cluster_first=None, passes=None):
    """Symmetric eigendecomposition, ascending.

    backend:
      * ``'auto'`` / ``'device'`` — plain ``jnp.linalg.eigh``
        (:func:`safe_eigh`).
      * ``'jacobi'`` — :func:`eigh_jacobi` (device eigh + Jacobi polish).
      * ``'newton'`` — :func:`eigh_newton` (refinement + cluster rotations;
        O(m^3) per step — the large-m / huge-nev path).
      * ``'host'``   — LAPACK via pure_callback.

    ``mesh`` (newton path only): partition the refinement work over the mesh
    devices — the spectrum-sliced parallel-``dsyevx`` analogue (see
    :func:`eigh_newton`).  Other backends ignore it (their work is already
    negligible or replicated by design).

    ``warm``/``warm_h1``/``cluster_first``/``passes`` (newton path only):
    warm start forwarded to :func:`eigh_newton` — GCG supplies its
    structural Rayleigh-Ritz warm start this way.
    """
    if backend == "host":
        return _host_eigh(h)
    if backend == "jacobi":
        return eigh_jacobi(h)
    if backend == "newton":
        return eigh_newton(h, mesh=mesh, warm=warm, warm_h1=warm_h1,
                           cluster_first=cluster_first, passes=passes)
    return safe_eigh(h)
