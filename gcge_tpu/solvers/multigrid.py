"""Multigrid: hierarchy construction, inter-level transfer, block AMG cycles.

Reference components covered (SURVEY.md §2):

* #8 ``ops_multi_grid.c`` — ``MultiVecFromItoJ``: move multivectors between
  levels by chained prolongation matvecs (coarse->fine ``P @ x``, fine->coarse
  ``P^T @ x``) — :func:`multivec_from_i_to_j`.
* #6 ``ops_lin_sol.c:466-715`` — ``BlockAMG``: recursive V-cycle over an
  ``A_array/P_array`` hierarchy with block-PCG smoothing on every level and
  per-level iteration/rate/tol knobs — :func:`bamg_solve`.
* The hierarchy itself: the reference delegates coarsening to PETSc GAMG /
  Hypre BoomerAMG (``app_slepc.c:366-445``, ``app_hypre.c:307-408``).  Here a
  self-contained *smoothed-aggregation* setup runs on host numpy/scipy
  (greedy strength-based aggregation, tentative piecewise-constant P, one
  damped-Jacobi smoothing pass, Galerkin ``A_c = P^T A P``), then ships every
  level to the device as ELL/DIA operators.  Setup is host-side by design —
  it happens once; all cycle math is jitted device code.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sps

from gcge_tpu.ops.multivec import col_dots
from gcge_tpu.ops.operators import make_operator
from gcge_tpu.solvers.bpcg import BlockPCGParams, block_pcg


@dataclass
class MGLevel:
    a_op: object                      # operator on this level
    p_op: Optional[object] = None     # prolongation to the FINER level (n_f x n_c)
    r_op: Optional[object] = None     # restriction = P^T  (n_c x n_f)
    b_op: Optional[object] = None     # projected mass matrix (generalized problems)
    dinv: Optional[object] = None     # 1/diag(A) — Chebyshev smoother scaling
    lam_max: Optional[float] = None   # upper bound on spec(D^-1 A) (static)


@dataclass
class MGHierarchy:
    """levels[0] = finest (the original operator), levels[-1] = coarsest."""

    levels: list[MGLevel] = field(default_factory=list)

    @property
    def num_levels(self):
        return len(self.levels)


# register as pytrees so whole hierarchies pass through jit boundaries —
# fused PAS sweeps take the hierarchy as an argument instead of baking the
# level matrices into the executable as constants
jax.tree_util.register_pytree_node(
    MGLevel,
    lambda lv: ((lv.a_op, lv.p_op, lv.r_op, lv.b_op, lv.dinv), (lv.lam_max,)),
    lambda aux, ch: MGLevel(a_op=ch[0], p_op=ch[1], r_op=ch[2], b_op=ch[3],
                            dinv=ch[4], lam_max=aux[0]),
)
jax.tree_util.register_pytree_node(
    MGHierarchy,
    lambda h: (tuple(h.levels), None),
    lambda aux, ch: MGHierarchy(levels=list(ch)),
)


def _aggregate(a: sps.csr_matrix, theta: float) -> np.ndarray:
    """Greedy strength-of-connection aggregation; returns aggregate id/node."""
    n = a.shape[0]
    d = np.sqrt(np.abs(a.diagonal())) + 1e-300
    agg = -np.ones(n, dtype=np.int64)
    indptr, indices, data = a.indptr, a.indices, a.data
    n_agg = 0
    # pass 1: roots with all-unaggregated strong neighborhoods
    for i in range(n):
        if agg[i] >= 0:
            continue
        sl = slice(indptr[i], indptr[i + 1])
        nbr = indices[sl]
        strong = nbr[np.abs(data[sl]) > theta * d[i] * d[nbr]]
        if (agg[strong] >= 0).any():
            continue
        agg[strong] = n_agg
        agg[i] = n_agg
        n_agg += 1
    # pass 2: attach leftovers to a strong aggregated neighbor (or own agg)
    for i in range(n):
        if agg[i] >= 0:
            continue
        sl = slice(indptr[i], indptr[i + 1])
        nbr = indices[sl]
        cand = nbr[agg[nbr] >= 0]
        if len(cand):
            order = np.argsort(-np.abs(data[sl][agg[nbr] >= 0]))
            agg[i] = agg[cand[order[0]]]
        else:
            agg[i] = n_agg
            n_agg += 1
    return agg


def build_hierarchy(
    rows,
    cols,
    vals,
    n: int,
    b_vals=None,
    max_levels: int = 4,
    min_coarse: int = 64,
    theta: float = 0.08,
    omega: float = 2.0 / 3.0,
    dtype=jnp.float64,
) -> MGHierarchy:
    """Smoothed-aggregation setup: returns device-ready hierarchy.

    ``b_vals`` (same pattern as A) additionally coarsens the mass matrix by
    the same Galerkin product, as the reference does via ``MatPtAP`` /
    ``BoomerAMGBuildCoarseOperatorKT`` (``app_slepc.c:420-436``,
    ``app_hypre.c:360-400``).
    """
    a = sps.coo_matrix((np.asarray(vals, np.float64),
                        (np.asarray(rows), np.asarray(cols))), shape=(n, n)).tocsr()
    b = None
    if b_vals is not None:
        b = sps.coo_matrix((np.asarray(b_vals, np.float64),
                            (np.asarray(rows), np.asarray(cols))), shape=(n, n)).tocsr()

    def dev(mat):
        coo = mat.tocoo()
        return make_operator(coo.row, coo.col, coo.data, mat.shape, dtype=dtype)

    def cheb_data(mat):
        """1/diag + a power-iteration bound on spec(D^-1 A) for Chebyshev."""
        dinv = 1.0 / np.maximum(np.abs(mat.diagonal()), 1e-300)
        v = np.random.default_rng(0).standard_normal(mat.shape[0])
        lam = 1.0
        for _ in range(20):
            v = dinv * (mat @ v)
            lam = np.linalg.norm(v)
            v /= max(lam, 1e-300)
        return jnp.asarray(dinv, dtype), float(1.1 * lam)

    hier = MGHierarchy()
    d0, l0 = cheb_data(a)
    hier.levels.append(MGLevel(a_op=dev(a), b_op=dev(b) if b is not None else None,
                               dinv=d0, lam_max=l0))

    while hier.num_levels < max_levels and a.shape[0] > min_coarse:
        agg = _aggregate(a, theta)
        n_c = int(agg.max()) + 1
        if n_c >= a.shape[0]:  # aggregation stalled
            break
        p_tent = sps.csr_matrix(
            (np.ones(a.shape[0]), (np.arange(a.shape[0]), agg)),
            shape=(a.shape[0], n_c),
        )
        # normalize tentative columns
        colnorm = np.sqrt(np.asarray(p_tent.multiply(p_tent).sum(axis=0)).ravel())
        p_tent = p_tent @ sps.diags(1.0 / np.maximum(colnorm, 1e-300))
        # one damped-Jacobi smoothing pass: P = (I - omega D^-1 A) P_tent
        dinv = sps.diags(1.0 / np.maximum(np.abs(a.diagonal()), 1e-300))
        p = (sps.eye(a.shape[0]) - omega * (dinv @ a)) @ p_tent
        p = p.tocsr()

        a_c = (p.T @ a @ p).tocsr()
        a_c.eliminate_zeros()
        pc = p.tocoo()
        p_op = make_operator(pc.row, pc.col, pc.data, p.shape, dtype=dtype)
        r_op = make_operator(pc.col, pc.row, pc.data, (p.shape[1], p.shape[0]),
                             dtype=dtype)
        # transfer lives on the FINER level's entry
        hier.levels[-1].p_op = p_op
        hier.levels[-1].r_op = r_op

        b_c_op = None
        if b is not None:
            b = (p.T @ b @ p).tocsr()
            b.eliminate_zeros()
            b_c_op = dev(b)
        a = a_c
        dc, lc = cheb_data(a)
        hier.levels.append(MGLevel(a_op=dev(a), b_op=b_c_op, dinv=dc, lam_max=lc))
    return hier


def multivec_from_i_to_j(hier: MGHierarchy, x: jax.Array, i: int, j: int) -> jax.Array:
    """Move a multivector from level i to level j (0 = finest) by chained
    prolongation/restriction matvecs — ``DefaultMultiVecFromItoJ``
    (``ops_multi_grid.c:69-117``).  Coarser = larger level index."""
    if i == j:
        return x
    if i < j:      # fine -> coarse: restrict
        for lvl in range(i, j):
            x = hier.levels[lvl].r_op.matvec(x)
    else:          # coarse -> fine: prolong
        for lvl in range(i - 1, j - 1, -1):
            x = hier.levels[lvl].p_op.matvec(x)
    return x


def chebyshev_smooth(a_matvec, dinv, b, x, lam_max: float, k: int,
                     alpha: float = 4.0):
    """``k`` steps of Chebyshev smoothing on ``A x = b``, Jacobi-preconditioned.

    Targets the upper spectrum ``[lam_max/alpha, lam_max]`` of ``D^-1 A``
    (standard smoothed-aggregation choice).  Unlike the CG smoother it needs
    NO inner products — on a distributed mesh a whole V-cycle then performs
    zero smoother collectives (only the transfer matvecs communicate), where
    the reference's BPCG smoothing pays 2 Allreduce per smoothing step
    (``ops_lin_sol.c:317,365``).  Fixed step count = fully static for XLA.
    """
    lmax = lam_max
    lmin = lam_max / alpha
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma
    r = b - a_matvec(x)
    d = (dinv[:, None] * r) / theta
    for _ in range(k - 1):
        x = x + d
        r = r - a_matvec(d)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * (dinv[:, None] * r)
        rho = rho_new
    return x + d


def _smooth(lv, b, x, iters, rate, tol, smoother):
    if smoother == "chebyshev" and lv.dinv is not None and lv.lam_max:
        return chebyshev_smooth(lv.a_op.matvec, lv.dinv, b, x, lv.lam_max,
                                iters)
    params = BlockPCGParams(max_iter=iters, rate=rate, tol=tol, tol_type="abs")
    x, _ = block_pcg(lv.a_op.matvec, b, x, params)
    return x


def _vcycle(hier, level, b, x, smooth_iters, coarse_iters, rate, tol,
            smoother: str = "cg"):
    lv = hier.levels[level]
    if level + 1 == hier.num_levels:
        # coarsest: (near-)exact solve by CG — the reference gives the
        # coarsest level a large per-level max_iter (ops_lin_sol.c:505-520)
        params = BlockPCGParams(max_iter=coarse_iters, rate=rate, tol=tol,
                                tol_type="abs")
        x, _ = block_pcg(lv.a_op.matvec, b, x, params)
        return x
    iters = smooth_iters[min(level, len(smooth_iters) - 1)]
    # pre-smooth
    x = _smooth(lv, b, x, iters, rate, tol, smoother)
    r = b - lv.a_op.matvec(x)
    r_c = lv.r_op.matvec(r)
    e_c = jnp.zeros((r_c.shape[0], r_c.shape[1]), r_c.dtype)
    e_c = _vcycle(hier, level + 1, r_c, e_c, smooth_iters, coarse_iters, rate,
                  tol, smoother)
    x = x + lv.p_op.matvec(e_c)
    # post-smooth
    return _smooth(lv, b, x, iters, rate, tol, smoother)


def bamg_solve(
    hier: MGHierarchy,
    b: jax.Array,
    x0: Optional[jax.Array] = None,
    max_cycles: int = 20,
    smooth_iters: Sequence[int] = (4, 4, 4, 4),
    coarse_iters: int = 100,
    rate: float = 1e-16,
    tol: float = 1e-13,
    rtol: float = 1e-8,
    level: int = 0,
    smoother: str = "cg",
):
    """Block AMG: repeated V-cycles until the blockwise relative residual
    drops below ``rtol`` (outer loop of ``BlockAMG``,
    ``ops_lin_sol.c:643-685``).  Returns ``(x, niter, rel_res)``.

    ``smoother``: ``'cg'`` (the reference's BPCG smoothing) or
    ``'chebyshev'`` (inner-product-free — zero smoother collectives on a
    mesh; needs hierarchies built by :func:`build_hierarchy`, which records
    ``dinv``/``lam_max`` per level).

    The whole V-cycle (a static recursion over levels) is traced ONCE into a
    single jitted program — every cycle is one dispatch.
    """
    a_op = hier.levels[level].a_op
    x = jnp.zeros_like(b) if x0 is None else x0
    nb = jnp.sqrt(col_dots(b, b))
    nb = jnp.maximum(nb, 1e-300)
    sub = MGHierarchy(levels=hier.levels[level:])
    si = tuple(smooth_iters)

    @jax.jit
    def cycle_and_residual(b, x):
        x = _vcycle(sub, 0, b, x, si, coarse_iters, rate, tol, smoother)
        r = b - a_op.matvec(x)
        rel = jnp.sqrt(col_dots(r, r)) / nb
        return x, rel

    it = 0
    rel = None
    for it in range(1, max_cycles + 1):
        x, rel = cycle_and_residual(b, x)
        if float(jnp.max(rel)) < rtol:
            break
    return x, it, rel


def bamg_preconditioner(hier: MGHierarchy, cycles: int = 1,
                        smooth_iters: Sequence[int] = (2, 2, 2, 2),
                        coarse_iters: int = 30, smoother: str = "chebyshev"):
    """AMG-V-cycle preconditioner for GCG's inner block CG.

    Returns a jit-traceable ``R -> M^{-1} R`` closure for
    ``GCGParams(linear_precond=...)`` — the reference's
    ``user_defined_multi_linear_solver = 2`` mode (external solver
    preconditions BPCG, ``ops_eig_sol_gcg.c:584-618``).  Default smoothing is
    Chebyshev so one application costs only matvecs (no reductions).
    """
    si = tuple(smooth_iters)

    def precond(r):
        e = jnp.zeros_like(r)
        for _ in range(cycles):
            e = _vcycle(hier, 0, r, e, si, coarse_iters, 1e-16, 1e-13,
                        smoother)
        return e

    return precond
