"""Device mesh utilities for row-partitioned eigensolving.

The reference distributes A, B and all multivectors by *row blocks* over MPI
ranks (SURVEY.md §2 "Parallelism strategies" #1; PETSc ``Mat``/``BV``,
``app_slepc.c:49-60``).  The equivalent here is a 1-D
``jax.sharding.Mesh`` with one axis, ``"rows"``; every (n, ...) array is
sharded on its first dimension and every projected/small quantity is
replicated.  XLA's SPMD partitioner then plays the role of the MPI layer:
block inner products become local GEMM + all-reduce, exactly the
local-product + ``MPI_Allreduce`` structure of
``ops_multi_vec.c:202-230`` — but inserted by the compiler.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ROWS = "rows"
COLS = "cols"


def row_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the row axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (ROWS,))


def grid_mesh(n_rows: int, n_cols: int, devices=None) -> Mesh:
    """2-D ``(rows, cols)`` mesh for very wide multivectors (nev >= ~1000).

    The basis ``V`` is sharded over BOTH dimensions; the operator's row
    blocks are replicated along the ``cols`` axis (each column group applies
    the same row block to its slice of columns).  The reference has no
    analogue — its multivectors always keep all columns per rank
    (``app_slepc.c:49-60``); this is the answer to the huge-nev regime
    where one device cannot hold ``n x (nevMax + 2bs)``.
    """
    if devices is None:
        devices = jax.devices()
    devices = np.asarray(devices[: n_rows * n_cols]).reshape(n_rows, n_cols)
    return Mesh(devices, (ROWS, COLS))


def row_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(ROWS))


def mv_spec(mesh: Mesh) -> P:
    """PartitionSpec for (n, m) multivectors on this mesh: rows always
    sharded; columns too when the mesh has a ``cols`` axis."""
    return P(ROWS, COLS) if COLS in mesh.axis_names else P(ROWS, None)


def shard_rows(mesh: Mesh, x: jax.Array) -> jax.Array:
    """Shard the leading (row) dimension of an array over the mesh."""
    spec = P(ROWS, *([None] * (x.ndim - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec))


def shard_mv(mesh: Mesh, x: jax.Array) -> jax.Array:
    """Shard a multivector ``(n, m)``: rows over ``rows``, and columns over
    ``cols`` when present (2-D meshes, :func:`grid_mesh`)."""
    if x.ndim < 2:
        return shard_rows(mesh, x)
    return jax.device_put(x, NamedSharding(mesh, mv_spec(mesh)))


def replicate(mesh: Mesh, x: jax.Array) -> jax.Array:
    return jax.device_put(x, NamedSharding(mesh, P()))


def pad_problem(a_op, b_op, n_devices: int, pad_value: float | None = None):
    """Pad a problem so n divides the device count.

    Padding must not disturb the *smallest* eigenpairs, so the padded rows get
    a large decoupled diagonal (their eigenvalues sort to the top of the
    spectrum) instead of zeros.  Returns ``(a_padded, b_padded, n_orig)``.
    Works on :class:`~gcge_tpu.ops.operators.SparseOperator` and
    ``DiagOperator``/``None``.
    """
    from gcge_tpu.ops.operators import DiagOperator, DiaOperator, SparseOperator

    n = a_op.shape[0]
    n_pad = (-n) % n_devices
    if n_pad == 0:
        return a_op, b_op, n
    if pad_value is None:
        pad_value = float(jnp.max(jnp.abs(a_op.values)) * n) if isinstance(
            a_op, (SparseOperator, DiaOperator)
        ) else 1e12

    def pad_square(op, diag_value):
        """Append n_pad decoupled rows with the given diagonal value."""
        if isinstance(op, DiaOperator):
            vals = jnp.pad(op.values, ((0, 0), (0, n_pad)))
            offsets = op.offsets
            if 0 in offsets:
                d0 = offsets.index(0)
            else:
                vals = jnp.concatenate(
                    [vals, jnp.zeros((1, n + n_pad), vals.dtype)], axis=0
                )
                offsets = offsets + (0,)
                d0 = len(offsets) - 1
            vals = vals.at[d0, n:].set(diag_value)
            return DiaOperator(vals, offsets, n + n_pad)
        if isinstance(op, SparseOperator):
            kmax = op.values.shape[1]
            pad_vals = jnp.zeros((n_pad, kmax), op.values.dtype)
            pad_vals = pad_vals.at[:, 0].set(diag_value)
            pad_idx = jnp.zeros((n_pad, kmax), op.indices.dtype)
            pad_idx = pad_idx.at[:, 0].set(
                n + jnp.arange(n_pad, dtype=op.indices.dtype))
            return SparseOperator(
                jnp.concatenate([op.values, pad_vals]),
                jnp.concatenate([op.indices, pad_idx]),
                n + n_pad,
            )
        from gcge_tpu.ops.operators import HybridOperator

        if isinstance(op, HybridOperator):
            return HybridOperator(pad_square(op.dia, diag_value), op.ell and
                                  _pad_ell_rows(op.ell, n_pad))
        if isinstance(op, DiagOperator):
            return DiagOperator(jnp.concatenate(
                [op.d, jnp.full((n_pad,), diag_value, op.d.dtype)]))
        raise NotImplementedError(type(op))

    def _pad_ell_rows(ell, k):
        # outlier part: padded rows carry no entries (zeros pointing at row 0)
        kmax = ell.values.shape[1]
        return SparseOperator(
            jnp.pad(ell.values, ((0, k), (0, 0))),
            jnp.pad(ell.indices, ((0, k), (0, 0))),
            ell.n_cols + k,
        )

    a_pad = pad_square(a_op, pad_value)
    # B pad rows get unit diagonal so the padded pencil eigenvalues are
    # pad_value / 1 — huge, sorted last
    b_pad = None if b_op is None else pad_square(b_op, 1.0)
    return a_pad, b_pad, n
