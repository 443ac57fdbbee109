"""gcge_tpu — a sparse eigensolver framework on JAX/XLA.

Computes the smallest ``nev`` eigenpairs of large symmetric (generalized)
eigenproblems ``A x = lambda B x`` with the GCG algorithm — a block damping
inverse-power iteration on the subspace ``V = [X, P, W]``:

* multivectors are plain ``jnp`` arrays of shape ``(n, m)`` (possibly sharded
  over a device mesh), every block op is a pure jittable function;
* all solver state is static-shape: convergence, rank deflation and the
  X/P/W bookkeeping of the reference (``/root/reference/src/ops_eig_sol_gcg.c``)
  are expressed with masks and counts instead of shrinking arrays;
* distribution is row-partitioning over a ``jax.sharding.Mesh`` with
  ``shard_map`` + ``psum``/``all_gather``/``ppermute`` collectives (the
  analogue of the reference's MPI row-blocks + ``MPI_Allreduce``);
* sparse operators pick a layout from the pattern (DIA shift-FMA for banded
  matrices, gather-ELL otherwise); every kernel is XLA's.

The reference's OPS vtable (``/root/reference/src/ops.h:43-152``) maps to a
small ``LinearOperator`` protocol plus the functional multivector ops in
``gcge_tpu.ops``.
"""

from gcge_tpu.ops.operators import (
    DenseOperator,
    DiagOperator,
    IdentityOperator,
    LinearOperator,
    ShiftedOperator,
    SparseOperator,
)
from gcge_tpu.api import eigsh, solve
from gcge_tpu.ops.operators import (DiaOperator, FunctionOperator,
                                    make_operator)
from gcge_tpu.solvers.gcg import GCGParams, GCGResult, gcg_solve
from gcge_tpu.solvers.bpcg import BlockPCGParams, block_pcg, pcg
from gcge_tpu.solvers.orth import bgs_orth, orth_block, orth_against

__version__ = "0.1.0"

__all__ = [
    "LinearOperator",
    "DenseOperator",
    "DiagOperator",
    "FunctionOperator",
    "DiaOperator",
    "IdentityOperator",
    "ShiftedOperator",
    "SparseOperator",
    "make_operator",
    "GCGParams",
    "GCGResult",
    "gcg_solve",
    "solve",
    "eigsh",
    "BlockPCGParams",
    "block_pcg",
    "pcg",
    "bgs_orth",
    "orth_block",
    "orth_against",
]
