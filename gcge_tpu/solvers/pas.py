"""PAS — Parallel Augmented Subspace multilevel eigensolver.

Reference: ``/root/reference/src/ops_eig_sol_pas.c`` (#9) and the composite
PASMAT/PASVEC backend ``/root/reference/app/app_pas.c`` (#10).  The method:
solve the eigenproblem once on the coarsest grid with GCG, then walk down the
hierarchy; on each finer level improve the eigenpairs with inverse-power
corrections solved by block AMG and a Rayleigh-Ritz step over the *augmented*
subspace that couples a small dense block with the fine-grid vectors.

Re-design:

* The composite object ``PASMAT = [XX XQ; QX QQ]`` acting on
  ``PASVEC = (dense u, grid q)`` (``app_pas.h:18-31``) becomes
  :class:`AugmentedOperator`: the pair is *stacked* into one ``(k + n, m)``
  array, so every existing kernel (orth, BPCG, GCG itself) works on the
  composite space unchanged — no second OPS layer, no split communicators.
  The reference's nonblocking-Allreduce-over-GEMM overlap
  (``app_pas.c:152-178``) is XLA's job: the dense block GEMM and the grid
  reduction live in one fused SPMD program.
* The per-level correction (``ComputeN``, ``ops_eig_sol_pas.c:345-390``)
  solves ``A_l N = B_l X diag(lambda)`` with :func:`bamg_solve`.
* The per-level Rayleigh-Ritz (``ComputeRayleighRitz`` on the composite
  operator, ``:50-249``) is performed over the explicit span ``[X | N]``
  with one B-orthonormalization and a replicated ``eigh`` — algebraically the
  same subspace the PASMAT-GCG iterates in, without re-entering GCG.

  **Why the explicit span instead of GCG on** :class:`AugmentedOperator`
  (the reference's design, ``ops_eig_sol_pas.c:183-219``): the stacked
  composite metric is only SEMI-definite — for ``s = [u; q]`` the B-inner
  product is ``(Xp u + q)^T B (Xp u + q)``, which vanishes on the whole
  subspace ``q = -Xp u``.  The reference runs GCG on that degenerate pencil
  and relies on its rank-revealing orthogonalization to continually deflate
  the null directions (``OrthXtoQ``'s aux-space B-solve, ``:391-532``,
  exists to fight exactly this).  The explicit span gives the same
  per-sweep subspace ``span[X | N]`` with a standard SPD metric, no
  deflation fights, and static shapes; the repeated
  correction+RR sweeps play the role of GCG's inner iterations on the
  composite operator.  :class:`AugmentedOperator` is still exported (and
  unit-tested) as the faithful PASMAT action for users building reference-
  style composite algorithms.
* Convergence is checked on the finest level only, as in the reference
  (``PAS``, ``:614-690``).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from functools import partial

from gcge_tpu.ops.multivec import col_dots, gram
from gcge_tpu.ops.operators import LinearOperator
from gcge_tpu.solvers.gcg import GCGParams, gcg_solve
from gcge_tpu.solvers.multigrid import MGHierarchy, _vcycle, bamg_solve
from gcge_tpu.solvers.orth import orth_block


@jax.tree_util.register_pytree_node_class
class AugmentedOperator(LinearOperator):
    """Galerkin operator on ``span(Xp) (+) V_fine`` over stacked vectors.

    For ``s = [u; q]`` (u dense coefficients of the promoted aux basis Xp,
    q a fine-grid vector), represents the fine vector ``t = Xp u + q`` and
    applies ``[Xp^T A t; A t]`` — exactly the action of the reference's
    ``PASMAT`` blocks ``[Xp^T A Xp, Xp^T A; A Xp, A]``
    (``app_pas.c:223-295``) computed with ONE fine operator application.
    """

    def __init__(self, a_fine: LinearOperator, xp: jax.Array):
        self.a_fine = a_fine
        self.xp = xp                    # (n, k) promoted aux basis

    @property
    def shape(self):
        n, k = self.xp.shape
        return (n + k, n + k)

    @property
    def dtype(self):
        return self.xp.dtype

    def matvec(self, s):
        k = self.xp.shape[1]
        u, q = s[:k], s[k:]
        t = self.xp @ u + q
        at = self.a_fine.matvec(t)
        return jnp.concatenate([self.xp.T @ at, at], axis=0)

    def to_fine(self, s):
        """Collapse a composite vector to the fine grid: ``Xp u + q``."""
        k = self.xp.shape[1]
        return self.xp @ s[:k] + s[k:]

    def tree_flatten(self):
        return (self.a_fine, self.xp), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@dataclass
class PASResult:
    eval: np.ndarray
    evec: jax.Array
    nev_conv: int
    level_history: list


def _rr_over_span(a_op, b_op, s, nev, zero_tol=1e-13):
    """B-orthonormalize the span ``s`` and Rayleigh-Ritz: returns (lam, x)."""
    bmv = None if b_op is None else b_op.matvec
    q, rank = orth_block(s, bmv, zero_tol=zero_tol)
    h = gram(q, a_op.matvec(q))
    h = 0.5 * (h + h.T)
    # mask deflated columns with a large diagonal so they sort last
    mvalid = (jnp.arange(s.shape[1]) < rank).astype(s.dtype)
    h = h * mvalid[None, :] * mvalid[:, None]
    big = jnp.max(jnp.sum(jnp.abs(h), axis=1)) + 1.0
    h = h + jnp.diag((1.0 - mvalid) * big)
    from gcge_tpu.ops.eighs import eigh

    w, c = eigh(h, "auto")
    return w[:nev], q @ c[:, :nev]


@jax.jit
def _rel_res_jit(a_op, b_op, x, lam):
    """Blockwise relative residuals, one dispatch."""
    bx = x if b_op is None else b_op.matvec(x)
    r = a_op.matvec(x) - bx * lam[None, :]
    return jnp.sqrt(col_dots(r, r)) / jnp.maximum(jnp.abs(lam), 1e-300)


@partial(jax.jit, static_argnames=("nev", "cycles", "smooth_iters",
                                   "coarse_iters", "composite"))
def _pas_sweep(hier_sub, a_op, b_op, x, lam, nev: int, cycles: int,
               smooth_iters=(4, 4, 4, 4), coarse_iters: int = 100,
               composite: bool = False):
    """One fused PAS sweep: inverse-power correction by ``cycles`` AMG
    V-cycles + Rayleigh-Ritz over the augmented span — ONE device dispatch
    (the reference pays per-phase MPI/host round-trips).

    ``composite=True`` runs the Rayleigh-Ritz through
    :class:`AugmentedOperator` — the reference-faithful PASMAT path
    (``ops_eig_sol_pas.c:183-219`` runs GCG on the composite
    ``[XX XQ; QX QQ]``; here the same composite action carries a direct
    RR): the span is expressed in stacked ``[u; q]`` coordinates
    ``[I, 0; 0, N]``, orthonormalized under the composite B-metric
    (semi-definite — the rank-revealing orth deflates any null
    directions, the job ``OrthXtoQ`` does upstream), projected via
    ``PASMAT``'s action, and the Ritz vectors collapsed back to the fine
    grid with ``to_fine``.  Algebraically the same subspace as the
    explicit-span path; exists so the composite backend is exercised by a
    production solver path, not only unit tests."""
    bx = x if b_op is None else b_op.matvec(x)
    rhs = bx * lam[None, :]
    e = x
    for _ in range(cycles):
        e = _vcycle(hier_sub, 0, rhs, e, smooth_iters, coarse_iters,
                    1e-16, 1e-13)
    if composite:
        from gcge_tpu.ops.operators import IdentityOperator

        n, k = x.shape
        aug_a = AugmentedOperator(a_op, x)
        aug_b = AugmentedOperator(
            b_op if b_op is not None else IdentityOperator(n, x.dtype), x)
        eye_k = jnp.eye(k, dtype=x.dtype)
        s = jnp.concatenate([
            jnp.concatenate([eye_k, jnp.zeros((n, k), x.dtype)], axis=0),
            jnp.concatenate([jnp.zeros((k, k), x.dtype), e], axis=0),
        ], axis=1)                                   # (k + n, 2k) stacked
        lam2, xc = _rr_over_span(aug_a, aug_b, s, nev)
        return lam2, aug_a.to_fine(xc)
    s = jnp.concatenate([x, e], axis=1)
    return _rr_over_span(a_op, b_op, s, nev)


@partial(jax.jit, static_argnames=("nev", "nev_out", "cycles", "max_sweeps",
                                   "smooth_iters", "coarse_iters"))
def _pas_sweeps_fused(hier_sub, a_op, b_op, x, lam, nev: int, nev_out: int,
                      cycles: int, max_sweeps: int, tol_rel: float,
                      smooth_iters=(4, 4, 4, 4), coarse_iters: int = 100):
    """Up to ``max_sweeps`` PAS sweeps in ONE ``lax.while_loop`` dispatch,
    exiting early once the first ``nev_out`` relative residuals meet
    ``tol_rel`` — even the convergence control stays on device (the
    phase-wise path syncs residuals to host between sweeps)."""

    def rel_res(x, lam):
        bx = x if b_op is None else b_op.matvec(x)
        r = a_op.matvec(x) - bx * lam[None, :]
        return jnp.sqrt(col_dots(r, r)) / jnp.maximum(jnp.abs(lam), 1e-300)

    def cond(st):
        x, lam, k, done = st
        return (k < max_sweeps) & (~done)

    def body(st):
        x, lam, k, _ = st
        lam, x = _pas_sweep(hier_sub, a_op, b_op, x, lam, nev, cycles,
                            smooth_iters, coarse_iters)
        done = jnp.all(rel_res(x, lam)[:nev_out] < tol_rel)
        return x, lam, k + 1, done

    x, lam, k, _ = jax.lax.while_loop(
        cond, body, (x, lam, jnp.int32(0), jnp.bool_(False)))
    return lam, x, k


def pas_solve(
    hier: MGHierarchy,
    nev: int,
    coarse_params: GCGParams | None = None,
    sweeps_per_level: int = 2,
    final_sweeps: int = 8,
    bamg_cycles: int = 6,
    tol_rel: float = 1e-8,
    verbose: int = 1,
    fuse: bool = True,
    composite_rr: bool = False,
) -> PASResult:
    """Multilevel PAS driver (reference ``PAS``, ``ops_eig_sol_pas.c:534-730``).

    ``hier`` must carry mass matrices (``build_hierarchy(..., b_vals=...)``)
    or the problem is treated as standard (B = I per level).

    ``composite_rr`` routes every per-level Rayleigh-Ritz through the
    stacked :class:`AugmentedOperator` (the reference's PASMAT composite,
    ``app_pas.c:223-295``) instead of the explicit fine span — same
    subspace, reference-faithful dataflow; implies ``fuse=False`` (the
    composite path keeps the phased per-sweep structure).
    """
    lvls = hier.levels
    top = hier.num_levels - 1

    # work with a guard buffer of extra vectors so the nev-th mode is not
    # polluted by the unresolved spectrum above it (the reference carries
    # nevMax = 2*nev for the same reason, test_eig_sol_pas.c).  A caller's
    # coarse_params.nev can only WIDEN the working block — never silently
    # shrink it below the guard width (it sets the subspace every finer
    # level inherits).
    nev_work = min(nev + max(2, nev // 2), lvls[top].a_op.shape[0] - 1)

    # ---- coarsest-grid eigensolve with GCG (ref :610-611) ----------------
    cp = coarse_params or GCGParams(nev=nev_work, verbose=0, max_iter=300)
    if coarse_params is not None and coarse_params.nev:
        nev_work = min(max(nev_work, coarse_params.nev),
                       lvls[top].a_op.shape[0] - 1)
    if cp.nev != nev_work:
        if verbose and coarse_params is not None:
            print(f"PAS: widening coarse nev {cp.nev} -> {nev_work} "
                  f"(guard buffer; pass coarse_params.nev >= {nev_work} "
                  f"to control it)")
        cp = GCGParams(**{**cp.__dict__, "nev": nev_work})
    nev, nev_out = nev_work, nev
    res = gcg_solve(lvls[top].a_op, lvls[top].b_op, cp)
    x = res.evec[:, :nev]
    lam = jnp.asarray(res.eval[:nev])
    history = [(top, np.asarray(lam).copy())]

    for level in range(top - 1, -1, -1):
        # PromoteX (ref :330-344)
        x = lvls[level].p_op.matvec(x)
        a_op, b_op = lvls[level].a_op, lvls[level].b_op
        n_sweeps = final_sweeps if level == 0 else sweeps_per_level
        hier_sub = MGHierarchy(levels=hier.levels[level:])
        if composite_rr:
            for sweep in range(n_sweeps):
                lam, x = _pas_sweep(hier_sub, a_op, b_op, x, lam, nev,
                                    bamg_cycles, composite=True)
                if level == 0:
                    rel = np.asarray(_rel_res_jit(a_op, b_op, x, lam))
                    if (rel[:nev_out] < tol_rel).all():
                        break
        elif fuse:
            # ComputeN (BAMG correction, ref :345-390) + augmented-span RR
            # (ref :50-249) + the convergence control, ALL sweeps of this
            # level in one while_loop dispatch
            lam, x, _ = _pas_sweeps_fused(
                hier_sub, a_op, b_op, x, lam, nev, nev_out, bamg_cycles,
                n_sweeps, tol_rel if level == 0 else 0.0)
        else:
            for sweep in range(n_sweeps):
                lam, x = _pas_sweep(hier_sub, a_op, b_op, x, lam, nev,
                                    bamg_cycles)
                if level == 0:
                    # finest level: stop once the wanted residuals meet tol
                    rel = np.asarray(_rel_res_jit(a_op, b_op, x, lam))
                    if (rel[:nev_out] < tol_rel).all():
                        break
        history.append((level, np.asarray(lam).copy()))
        if verbose:
            print(f"PAS level {level}: lam[0:3] = {np.asarray(lam)[:3]}")

    # convergence check on the finest level (ref :620-637)
    rel = np.asarray(_rel_res_jit(lvls[0].a_op, lvls[0].b_op, x, lam))
    nev_conv = int(np.sum(np.cumprod(rel[:nev_out] < tol_rel)))
    return PASResult(
        eval=np.asarray(lam)[:nev_out],
        evec=x[:, :nev_out],
        nev_conv=nev_conv,
        level_history=history,
    )
