"""Distributed multigrid: sharded fine level, replicated coarse levels.

The reference redistributes coarse-grid matrices onto a SUBSET of MPI ranks
(``proc_rate[]`` comm-split + intercomm machinery,
``/root/reference/app/app_slepc.c:648-809``) because tiny coarse levels are
latency-bound: an Allreduce over 1152 ranks costs more than the coarse solve.
The resolution here is stronger: the finest level (where all the data
is) stays row-sharded over the mesh, and every coarser level is fully
REPLICATED — each device redundantly computes the identical (tiny) coarse
work, which costs no communication at all and keeps XLA's program SPMD.
Only the level-0 smoother matvecs (neighbor-halo / all-gather, via
``RowShardedOperator``) and the two level-0 transfers communicate:

* prolong  (replicated coarse -> sharded fine): each device applies ITS rows
  of P against the full coarse block — no collective;
* restrict (sharded fine -> replicated coarse): each device scatter-adds its
  local P rows into a coarse-size buffer, then one ``psum``.

Wrapped hierarchies drop into the existing :func:`~gcge_tpu.solvers.multigrid.
bamg_solve` / :func:`~gcge_tpu.solvers.multigrid.bamg_preconditioner`
unchanged — the V-cycle code is agnostic to where its arrays live.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from gcge_tpu.ops.operators import LinearOperator, SparseOperator
from gcge_tpu.parallel.dist_ops import RowShardedOperator, shard_operator
from gcge_tpu.parallel.mesh import ROWS, shard_rows
from gcge_tpu.solvers.multigrid import MGHierarchy, MGLevel


@jax.tree_util.register_pytree_node_class
class ProlongOperator(LinearOperator):
    """``P @ x``: replicated coarse multivector -> row-sharded fine.

    ``ell`` is the prolongation in ELL layout (n_fine x n_coarse), its rows
    sharded over the mesh.  No collective: every device already holds the
    full coarse block."""

    def __init__(self, ell: SparseOperator, mesh: Mesh):
        self.ell = ell
        self.mesh = mesh

    @property
    def shape(self):
        return self.ell.shape

    @property
    def dtype(self):
        return self.ell.dtype

    def matvec(self, x):
        n_cols = self.ell.n_cols

        def f(values, indices, xg):
            return SparseOperator(values, indices, n_cols).matvec(xg)

        return shard_map(
            f, mesh=self.mesh,
            in_specs=(P(ROWS, None), P(ROWS, None), P(None, None)),
            out_specs=P(ROWS, None), check_vma=False,
        )(self.ell.values, self.ell.indices, x)

    def tree_flatten(self):
        return (self.ell,), (self.mesh,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0])


@jax.tree_util.register_pytree_node_class
class RestrictOperator(LinearOperator):
    """``P^T @ r``: row-sharded fine multivector -> replicated coarse.

    Uses the SAME fine-row-sharded P storage as :class:`ProlongOperator`
    (no transposed copy): each device scatter-adds its local rows'
    contributions ``P[i, j] * r[i, :]`` into a coarse-size buffer, then one
    ``psum`` over the mesh — the single collective of the restriction."""

    def __init__(self, ell: SparseOperator, mesh: Mesh):
        self.ell = ell                    # (n_fine x n_coarse), rows sharded
        self.mesh = mesh

    @property
    def shape(self):
        return (self.ell.n_cols, self.ell.shape[0])

    @property
    def dtype(self):
        return self.ell.dtype

    def matvec(self, r):
        n_c = self.ell.n_cols

        def f(values, indices, r_local):
            m = r_local.shape[1]
            contrib = (values[:, :, None] * r_local[:, None, :])
            out = jnp.zeros((n_c, m), r_local.dtype)
            out = out.at[indices.reshape(-1)].add(
                contrib.reshape(-1, m), mode="drop")
            return jax.lax.psum(out, ROWS)

        return shard_map(
            f, mesh=self.mesh,
            in_specs=(P(ROWS, None), P(ROWS, None), P(ROWS, None)),
            out_specs=P(None, None), check_vma=False,
        )(self.ell.values, self.ell.indices, r)

    def tree_flatten(self):
        return (self.ell,), (self.mesh,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0])


def _as_ell(op) -> SparseOperator:
    """Transfer operators come out of build_hierarchy as ELL (rectangular
    matrices never take the DIA path); assert rather than convert."""
    assert isinstance(op, SparseOperator), (
        f"transfer operator must be ELL, got {type(op).__name__}")
    return op


def shard_hierarchy(hier: MGHierarchy, mesh: Mesh) -> MGHierarchy:
    """Distribute a hierarchy: level 0 row-sharded, coarser levels replicated.

    Level 0's row count must divide the mesh's ``rows`` axis (use
    :func:`~gcge_tpu.parallel.mesh.pad_problem` on the fine matrix BEFORE
    ``build_hierarchy`` — padded rows aggregate into isolated singletons and
    never pollute the coarse spectrum).  The returned hierarchy drops into
    ``bamg_solve`` / ``bamg_preconditioner`` / ``pas_solve`` unchanged.
    """
    assert hier.num_levels >= 1
    lv0 = hier.levels[0]
    n0 = lv0.a_op.shape[0]
    ndev = mesh.shape[ROWS]
    assert n0 % ndev == 0, (
        f"finest level rows {n0} must divide the mesh ({ndev} devices); "
        "pad_problem the fine matrix before build_hierarchy")
    new0 = MGLevel(
        a_op=shard_operator(lv0.a_op, mesh),
        b_op=shard_operator(lv0.b_op, mesh) if lv0.b_op is not None else None,
        dinv=shard_rows(mesh, lv0.dinv) if lv0.dinv is not None else None,
        lam_max=lv0.lam_max,
    )
    if lv0.p_op is not None:
        p_ell = _as_ell(lv0.p_op)
        p_sh = SparseOperator(shard_rows(mesh, p_ell.values),
                              shard_rows(mesh, p_ell.indices), p_ell.n_cols)
        new0.p_op = ProlongOperator(p_sh, mesh)
        new0.r_op = RestrictOperator(p_sh, mesh)
    # coarse levels replicated verbatim: every device computes them
    # identically with zero communication (the proc_rate[] analogue)
    return MGHierarchy(levels=[new0] + list(hier.levels[1:]))
