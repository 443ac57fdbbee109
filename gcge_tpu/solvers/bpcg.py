"""Block preconditioned conjugate gradient with per-column convergence masks.

Re-design of ``BlockPCG`` (reference ``src/ops_lin_sol.c:140-437``).
The reference compacts converged columns out of an ``unconv[]`` index list and
batches matvecs over contiguous runs; under XLA we keep every shape static and
instead *freeze* converged columns with a mask: their ``alpha``/``beta`` become
zero so ``x, r, p`` stop changing, while the matvec always runs on the full
block (one large SpMM call per iteration — one big matvec beats many
ragged ones).  The loop is a single ``lax.while_loop`` so the whole solve
is one compiled region with an early exit when every column froze — the
analogue of ``while (niter<max_iter && num_unconv>0)``.

Collectives: the two per-iteration reductions (``pTw`` and ``rho2``,
``ops_lin_sol.c:313-321,361-369`` — one ``MPI_Allreduce`` each) become ``psum``
automatically when the caller's matvec/inner ops run under ``shard_map``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp


@dataclass(frozen=True)
class BlockPCGParams:
    """Mirror of the reference's BlockPCG knobs (``ops_lin_sol.h:29-44``)."""

    max_iter: int = 50
    rate: float = 1e-2          # stop when res <= rate * initial res (per col)
    tol: float = 1e-12          # absolute/relative floor per column
    tol_type: str = "abs"       # 'abs' | 'rel' | 'user'


@dataclass
class BlockPCGInfo:
    niters: jax.Array           # scalar int32 — iterations executed
    final_res: jax.Array        # (m,) final residual 2-norms
    init_res: jax.Array         # (m,) initial residual 2-norms


def _col_dots(x, y, psum_axis=None):
    # elementwise multiply + sum (see multivec.col_dots): no GEMM, so an
    # f32 solve never drops to TF32
    d = jnp.sum(x * y, axis=0)
    if psum_axis is not None:
        d = jax.lax.psum(d, psum_axis)
    return d


def block_pcg(
    matvec,
    b: jax.Array,
    x0: jax.Array,
    params: BlockPCGParams = BlockPCGParams(),
    active0: jax.Array | None = None,
    norm_b: jax.Array | None = None,
    psum_axis: str | None = None,
    precond=None,
):
    """Solve ``op @ x = b`` column-by-column with block CG.

    Parameters
    ----------
    matvec: multivector product ``X -> op @ X`` (op symmetric positive
        definite; pass a closure over :class:`~gcge_tpu.ops.ShiftedOperator`
        for the GCG inner solve).
    b, x0: ``(n, m)`` right-hand sides and initial guesses.
    active0: optional ``(m,)`` boolean mask — columns False are never touched
        (the GCG W-solve activates only the unconverged window).
    norm_b: per-column norms for ``tol_type='user'``
        (the reference's user-defined norm path, ``ops_lin_sol.c:186-192``).
    psum_axis: mesh axis name when running inside ``shard_map`` — inner
        products reduce with ``psum`` over it.
    precond: optional multivector preconditioner ``R -> M^{-1} R`` (must be
        jit-traceable).  This is the reference's
        ``user_defined_multi_linear_solver = 2`` mode, where an external
        solver preconditions the built-in BPCG
        (``ops_eig_sol_gcg.c:584-618``).

    Returns ``(x, BlockPCGInfo)``.
    """
    m = b.shape[1]
    dtype = b.dtype
    if active0 is None:
        active0 = jnp.ones((m,), dtype=bool)

    if params.tol_type == "rel":
        nb = jnp.sqrt(_col_dots(b, b, psum_axis))
    elif params.tol_type == "user":
        assert norm_b is not None, "tol_type='user' requires norm_b"
        nb = jnp.abs(norm_b)
    else:
        nb = jnp.ones((m,), dtype=dtype)

    def apply_m(r):
        return r if precond is None else precond(r)

    r = b - matvec(x0)
    r = jnp.where(active0[None, :], r, 0.0)
    z = apply_m(r)
    rho = _col_dots(r, z, psum_axis)            # r.z (= r.r unpreconditioned)
    res2 = rho if precond is None else _col_dots(r, r, psum_axis)
    init_res = jnp.sqrt(res2)
    active = active0 & (init_res > params.tol * nb)

    rate = jnp.asarray(params.rate, dtype)
    tol = jnp.asarray(params.tol, dtype)

    def cond(state):
        niter, x, r, z, p, rho_prev, rho_cur, res, active = state
        return (niter < params.max_iter) & jnp.any(active)

    def body(state):
        niter, x, r, z, p, rho_prev, rho_cur, res, active = state
        beta = jnp.where(
            (niter > 0) & active & (rho_prev > 0), rho_cur / jnp.where(rho_prev > 0, rho_prev, 1.0), 0.0
        )
        p = jnp.where(active[None, :], z + beta[None, :] * p, 0.0)
        w = matvec(p)
        ptw = _col_dots(p, w, psum_axis)
        # no positivity guard: GCG's damped operator (A + sigma*B) is
        # deliberately indefinite and the reference runs plain CG on it
        # (ops_lin_sol.c:332); only division by exact zero is avoided.
        alpha = jnp.where(active & (ptw != 0), rho_cur / jnp.where(ptw != 0, ptw, 1.0), 0.0)
        x = x + alpha[None, :] * p
        r = r - alpha[None, :] * w
        z = apply_m(r)
        rho_next = _col_dots(r, z, psum_axis)
        res2 = rho_next if precond is None else _col_dots(r, r, psum_axis)
        res = jnp.sqrt(res2)
        still = active & (res > rate * init_res) & (res > tol * nb)
        return (niter + 1, x, r, z, p, rho_cur, rho_next, res, still)

    state0 = (jnp.int32(0), x0, r, z, jnp.zeros_like(r), rho, rho, init_res, active)
    niter, x, r, z, p, rho_prev, rho_cur, res, active = jax.lax.while_loop(cond, body, state0)
    return x, BlockPCGInfo(niters=niter, final_res=res, init_res=init_res)


def block_pcg_t(
    matvec_t,
    bt: jax.Array,
    x0t: jax.Array,
    params: BlockPCGParams = BlockPCGParams(),
    active0: jax.Array | None = None,
    psum_axis: str | None = None,
    norm_b: jax.Array | None = None,
    precond=None,
):
    """Transposed-layout block CG: all arrays are ``(m, n)`` (columns of the
    mathematical multivector live on ROWS; the grid index is the last,
    contiguous axis).  This is the layout of ``DiaOperator.matvec_t`` —
    running the whole CG loop here makes the inner solve transpose-free.  Semantics identical to :func:`block_pcg`,
    including the ``tol_type='user'``/``norm_b`` stopping rule
    (``ops_lin_sol.c:186-192``) and the ``precond`` hook (``R -> M^{-1} R``
    in the SAME (m, n) layout) — the reference composes an external solver
    as a BPCG preconditioner via ``user_defined_multi_linear_solver = 2``
    (``ops_eig_sol_gcg.c:584-618``), and the mixed-precision inner solve
    must compose the same way."""
    m = bt.shape[0]
    dtype = bt.dtype
    if active0 is None:
        active0 = jnp.ones((m,), dtype=bool)

    def dots(x, y):
        d = jnp.sum(x * y, axis=1)  # elementwise, as _col_dots
        if psum_axis is not None:
            d = jax.lax.psum(d, psum_axis)
        return d

    if params.tol_type == "rel":
        nb = jnp.sqrt(dots(bt, bt))
    elif params.tol_type == "user":
        assert norm_b is not None, "tol_type='user' requires norm_b"
        nb = jnp.abs(norm_b).astype(dtype)
    else:
        nb = jnp.ones((m,), dtype=dtype)

    def apply_m(r):
        return r if precond is None else precond(r)

    r = bt - matvec_t(x0t)
    r = jnp.where(active0[:, None], r, 0.0)
    z = apply_m(r)
    rho = dots(r, z)                  # = r.r unpreconditioned
    res2 = rho if precond is None else dots(r, r)
    init_res = jnp.sqrt(res2)
    active = active0 & (init_res > params.tol * nb)
    rate = jnp.asarray(params.rate, dtype)
    tol = jnp.asarray(params.tol, dtype)

    def cond(st):
        niter, x, r, z, p, rho_prev, rho_cur, res, active = st
        return (niter < params.max_iter) & jnp.any(active)

    def body(st):
        niter, x, r, z, p, rho_prev, rho_cur, res, active = st
        beta = jnp.where((niter > 0) & active & (rho_prev > 0),
                         rho_cur / jnp.where(rho_prev > 0, rho_prev, 1.0), 0.0)
        p = jnp.where(active[:, None], z + beta[:, None] * p, 0.0)
        w = matvec_t(p)
        ptw = dots(p, w)
        alpha = jnp.where(active & (ptw != 0),
                          rho_cur / jnp.where(ptw != 0, ptw, 1.0), 0.0)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * w
        z = apply_m(r)
        rho_next = dots(r, z)
        res2 = rho_next if precond is None else dots(r, r)
        res = jnp.sqrt(res2)
        still = active & (res > rate * init_res) & (res > tol * nb)
        return (niter + 1, x, r, z, p, rho_cur, rho_next, res, still)

    st0 = (jnp.int32(0), x0t, r, z, jnp.zeros_like(r), rho, rho, init_res,
           active)
    niter, x, r, z, p, rho_prev, rho_cur, res, active = \
        jax.lax.while_loop(cond, body, st0)
    return x, BlockPCGInfo(niters=niter, final_res=res, init_res=init_res)


def pcg(matvec, b: jax.Array, x0: jax.Array, max_iter=50, rate=1e-2, tol=1e-12,
        psum_axis: str | None = None):
    """Single-vector CG (reference ``PCG``, ``ops_lin_sol.c:62-113``).

    Thin wrapper over :func:`block_pcg` on a one-column block; the stopping
    rule matches the reference: relative *decrease* ``rate`` plus absolute
    floor ``tol``.
    """
    x, info = block_pcg(
        matvec,
        b[:, None],
        x0[:, None],
        BlockPCGParams(max_iter=max_iter, rate=rate, tol=tol, tol_type="abs"),
        psum_axis=psum_axis,
    )
    return x[:, 0], info
