"""Multi-host (multi-process) bring-up and per-host data ingestion.

The reference scales over MPI ranks launched by ``mpiexec`` and reads/builds
each rank's row block locally (PETSc ``MatLoad``/PHG assembly,
``/root/reference/test/test_app_slepc.c:416-440``, ``app_phg.c:51-67``).  The
equivalent here is a multi-process JAX program:

* :func:`bootstrap` — ``jax.distributed.initialize`` with the coordinator
  address, process count and process id passed explicitly.
* :func:`hybrid_row_mesh` — a 1-D ``rows`` mesh ordered so contiguous row
  blocks live on devices of the same host: the neighbor-halo DIA exchange
  then stays inside a host between in-host neighbors and crosses the
  network only at the host boundaries (2 messages of ``halo x m`` per host
  pair per matvec, the minimum possible).
* :func:`mv_from_host_blocks` / :func:`dia_from_host_blocks` /
  :func:`ell_from_host_blocks` — assemble GLOBAL sharded arrays from
  process-local row blocks without ever materializing the global matrix on
  one host (each host packs only its rows, the analogue of per-rank
  ``MatLoad``).

Everything here also works single-process (process_count == 1), which is how
the test suite exercises it on the 8-device virtual CPU mesh.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gcge_tpu.parallel.mesh import ROWS, mv_spec


def bootstrap(coordinator_address: str | None = None,
              num_processes: int | None = None,
              process_id: int | None = None,
              local_device_ids=None) -> tuple[int, int]:
    """Initialize multi-process JAX (idempotent).

    Pass the arguments explicitly (or set
    ``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID``).
    Returns ``(process_id, process_count)``.  The reference's counterpart is
    ``MPI_Init`` (``test/main.c``); collectives afterwards are XLA's, not
    MPI's.
    """
    # IMPORTANT: do not touch jax.process_count()/jax.devices() here — any
    # backend query initializes XLA, after which distributed.initialize()
    # refuses to run.
    if coordinator_address is not None and not jax.distributed.is_initialized():
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )
    return jax.process_index(), jax.process_count()


def hybrid_row_mesh(devices=None) -> Mesh:
    """1-D ``rows`` mesh in host-major device order.

    ``jax.devices()`` is already sorted by process index, so contiguous row
    blocks map to devices grouped by host: halo ppermutes between block
    neighbors stay inside a host and cross the network only once per host
    boundary.  (For bandwidth-bound all-gather operators consider a 2-D
    ``grid_mesh`` with hosts on the outer axis instead.)
    """
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (ROWS,))


def _global_rows(mesh: Mesh, local_rows: int) -> int:
    """Global row count implied by equal per-process blocks."""
    return local_rows * jax.process_count()


def mv_from_host_blocks(mesh: Mesh, local_block, n_global: int | None = None):
    """Assemble a row-sharded global multivector from per-process row blocks.

    ``local_block`` is this process's ``(n_local, m)`` (numpy or device)
    block; every process calls with its own rows, in mesh order.  No host
    ever holds the global array.
    """
    local_block = np.asarray(local_block)
    if n_global is None:
        n_global = _global_rows(mesh, local_block.shape[0])
    spec = mv_spec(mesh) if local_block.ndim >= 2 else P(ROWS)
    sharding = NamedSharding(mesh, spec)
    global_shape = (n_global,) + local_block.shape[1:]
    return jax.make_array_from_process_local_data(
        sharding, local_block, global_shape)


def dia_from_host_blocks(mesh: Mesh, local_values, offsets,
                         n_global: int | None = None):
    """Assemble a row-sharded :class:`~gcge_tpu.ops.operators.DiaOperator`
    from per-process DIA value blocks.

    ``local_values``: ``(ndiag, n_local)`` — this process's row block of the
    diagonal storage, ``local_values[d, i] = A[r0 + i, r0 + i + offsets[d]]``
    with entries pointing outside the GLOBAL matrix stored as zero.  The
    offsets tuple must be identical on every process (it is static
    structure).  Wrapped in a RowShardedOperator ready for ``gcg_solve``.
    """
    from gcge_tpu.ops.operators import DiaOperator
    from gcge_tpu.parallel.dist_ops import RowShardedOperator

    local_values = np.asarray(local_values)
    ndiag, n_local = local_values.shape
    if n_global is None:
        n_global = _global_rows(mesh, n_local)
    sharding = NamedSharding(mesh, P(None, ROWS))
    vals = jax.make_array_from_process_local_data(
        sharding, local_values, (ndiag, n_global))
    return RowShardedOperator(DiaOperator(vals, tuple(offsets), n_global),
                              mesh)


def ell_from_host_blocks(mesh: Mesh, local_values, local_indices,
                         n_global: int | None = None):
    """Assemble a row-sharded ELL :class:`~gcge_tpu.ops.operators.SparseOperator`
    from per-process row blocks (indices are GLOBAL column numbers)."""
    from gcge_tpu.ops.operators import SparseOperator
    from gcge_tpu.parallel.dist_ops import RowShardedOperator

    local_values = np.asarray(local_values)
    local_indices = np.asarray(local_indices, np.int32)
    n_local, kmax = local_values.shape
    if n_global is None:
        n_global = _global_rows(mesh, n_local)
    sharding = NamedSharding(mesh, P(ROWS, None))
    vals = jax.make_array_from_process_local_data(
        sharding, local_values, (n_global, kmax))
    idx = jax.make_array_from_process_local_data(
        sharding, local_indices, (n_global, kmax))
    return RowShardedOperator(SparseOperator(vals, idx, n_global), mesh)
