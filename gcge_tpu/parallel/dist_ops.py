"""Row-sharded operators: explicit shard_map SpMM over the mesh.

The reference's distributed SpMM (PHG backend, ``app_phg.c:292-359``) scatters
the needed halo of x, runs the local SpMM, and accumulates off-process rows —
point-to-point halo exchange overlapped with compute.  Here banded (DIA)
operators do the same with two ``ppermute`` halo messages per matvec; other
layouts ``all_gather`` the (thin) multivector once and each device SpMMs its
local row block against the global x.  For x of shape (n, bs) with
bs = O(block_size) that moves n*bs values per device per matvec.

``RowShardedOperator`` wraps any inner operator whose arrays are row-sharded;
``matvec`` runs under ``shard_map`` so collectives are explicit and the inner
computation uses only local shards.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from gcge_tpu.ops.operators import (
    DenseOperator,
    DiaOperator,
    DiagOperator,
    HybridOperator,
    IdentityOperator,
    LinearOperator,
    SparseOperator,
)
from gcge_tpu.parallel.mesh import COLS, ROWS, shard_rows


def _mv_spec_for(mesh: Mesh, x) -> P:
    """Column-sharded spec on 2-D meshes, but only when the (static) column
    count divides the cols axis — narrow windows (residual checks, odd
    blocks) otherwise run rows-sharded/cols-replicated; GSPMD inserts the
    resharding."""
    if COLS in mesh.axis_names and x.shape[1] % mesh.shape[COLS] == 0:
        return P(ROWS, COLS)
    return P(ROWS, None)


@jax.tree_util.register_pytree_node_class
class RowShardedOperator(LinearOperator):
    """Operator with rows sharded over the ``"rows"`` mesh axis.

    ``inner`` holds row-sharded arrays (values/indices for sparse, the row
    block for dense).  ``matvec`` all-gathers the input multivector over the
    mesh axis and applies the local row block — the explicit-collective
    equivalent of the reference's row-partitioned backends (SURVEY.md §2).
    """

    def __init__(self, inner: LinearOperator, mesh: Mesh):
        self.inner = inner
        self.mesh = mesh

    @property
    def shape(self):
        return self.inner.shape

    @property
    def dtype(self):
        return self.inner.dtype

    def matvec(self, x):
        inner = self.inner

        if isinstance(inner, (DiagOperator, IdentityOperator)):
            # purely local — no communication needed
            return inner.matvec(x)

        xspec = _mv_spec_for(self.mesh, x)

        if isinstance(inner, SparseOperator):
            n_cols = inner.n_cols

            def f(values, indices, x_local):
                xg = jax.lax.all_gather(x_local, ROWS, axis=0, tiled=True)
                # the SpMM runs in the input's precision: f32 input (the
                # mixed inner CG's stages) takes the f32 SpMM
                local = SparseOperator(values.astype(xg.dtype), indices,
                                       n_cols)
                return local.matvec(xg)

            return shard_map(
                f,
                mesh=self.mesh,
                in_specs=(P(ROWS, None), P(ROWS, None), xspec),
                out_specs=xspec,
                check_vma=False,
            )(inner.values, inner.indices, x)

        if isinstance(inner, DiaOperator):
            return self._dia_matvec(x)

        if isinstance(inner, HybridOperator):
            # banded core rides the neighbor-halo path; the thin outlier ELL
            # all-gathers (its columns are arbitrary by construction)
            y = RowShardedOperator(inner.dia, self.mesh).matvec(x)
            if inner.ell is not None:
                y = y + RowShardedOperator(inner.ell, self.mesh).matvec(x)
            return y

        if isinstance(inner, DenseOperator):

            def f(a_local, x_local):
                xg = jax.lax.all_gather(x_local, ROWS, axis=0, tiled=True)
                return a_local @ xg

            return shard_map(
                f,
                mesh=self.mesh,
                in_specs=(P(ROWS, None), xspec),
                out_specs=xspec,
                check_vma=False,
            )(inner.a, x)

        raise NotImplementedError(type(inner))

    def _dia_matvec(self, x):
        """Banded SpMM with *neighbor halo* exchange.

        A DIA matrix couples row ``i`` only to rows ``i + off_d`` with static
        offsets, so a device owning a contiguous row block needs just
        ``hl = -min(off)`` rows from its left neighbor and ``hr = max(off)``
        from its right — two ``ppermute`` messages of ``halo * m`` values
        instead of all-gathering the full ``(n, m)`` multivector.  This is
        the form of the reference's point-to-point halo-exchange
        SpMM (PHG backend, reference ``app/app_phg.c:292-359``); XLA can
        overlap the ppermutes with the interior shift-FMA work.  Wraparound
        halo rows at the global boundary are annihilated by the DIA zero
        padding (``A[i, i+off]`` outside the matrix is stored as 0).  Falls
        back to all-gather + windowing when the band exceeds the local block.
        """
        inner, mesh = self.inner, self.mesh
        ndev = mesh.shape[ROWS]
        xspec = _mv_spec_for(mesh, x)
        offsets, n_cols = inner.offsets, inner.n_cols
        hl = max(0, -min(offsets))
        hr = max(0, max(offsets))
        n = inner.shape[0]
        ln = n // ndev
        halo_ok = ndev > 1 and hl <= ln and hr <= ln

        vals_args = (inner.values,)

        def apply_window(v, xw):
            # y[i] = sum_d v[d, i] * xw[hl + i + off_d], in xw's precision
            v = v.astype(xw.dtype)
            y = jnp.zeros((v.shape[1], xw.shape[1]), xw.dtype)
            for d, off in enumerate(offsets):
                y = y + v[d][:, None] * jax.lax.slice_in_dim(
                    xw, hl + off, hl + off + v.shape[1], axis=0)
            return y

        vspecs = (P(None, ROWS),) * len(vals_args)

        if ndev == 1:
            def f1(*args):
                *vals, x_local = args
                xw = jnp.pad(x_local, ((hl, hr), (0, 0)))
                return apply_window(*vals, xw)

            return shard_map(
                f1, mesh=mesh,
                in_specs=(*vspecs, xspec),
                out_specs=xspec, check_vma=False,
            )(*vals_args, x)

        if halo_ok:
            fwd = [(i, (i + 1) % ndev) for i in range(ndev)]
            bwd = [(i, (i - 1) % ndev) for i in range(ndev)]

            def f(*args):
                # The PHG overlap pattern (``app_phg.c:292-359``:
                # scatter-begin -> local SpMM -> scatter-end -> off-process
                # accumulation), expressed as DATAFLOW: the interior SpMM
                # consumes a ZERO halo so it carries no dependency on the
                # ppermutes, and the halo contributions are separate small
                # edge corrections — XLA's async collective-permute can then
                # overlap the exchange with the interior shift-FMA instead of
                # serializing behind the window concatenation.
                *vals, x_local = args
                m = x_local.shape[1]
                left = jax.lax.ppermute(x_local[ln - hl:], ROWS, fwd) \
                    if hl else None
                right = jax.lax.ppermute(x_local[:hr], ROWS, bwd) \
                    if hr else None
                xw0 = jnp.pad(x_local, ((hl, hr), (0, 0)))
                y = apply_window(*vals, xw0)          # interior, halo-free
                vmain = vals[0]                       # (ndiag, ln)

                def vrow(d, sl):
                    return vmain[d, sl].astype(y.dtype)

                # edge corrections: offsets crossing the left boundary touch
                # only rows [0, -off), the right boundary rows [ln-off, ln)
                dl = jnp.zeros((hl, m), y.dtype) if hl else None
                dr = jnp.zeros((hr, m), y.dtype) if hr else None
                for d, off in enumerate(offsets):
                    if off < 0 and hl:
                        k = -off
                        dl = dl.at[:k].add(
                            vrow(d, slice(0, k))[:, None]
                            * left[hl - k:].astype(y.dtype))
                    elif off > 0 and hr:
                        dr = dr.at[hr - off:].add(
                            vrow(d, slice(ln - off, ln))[:, None]
                            * right[:off].astype(y.dtype))
                if hl:
                    y = y.at[:hl].add(dl)
                if hr:
                    y = y.at[ln - hr:].add(dr)
                return y
        else:
            def f(*args):
                *vals, x_local = args
                xg = jax.lax.all_gather(x_local, ROWS, axis=0, tiled=True)
                xpad = jnp.pad(xg, ((hl, hr), (0, 0)))
                r0 = jax.lax.axis_index(ROWS) * ln
                xw = jax.lax.dynamic_slice(
                    xpad, (r0, jnp.int32(0)), (hl + ln + hr, x_local.shape[1]))
                return apply_window(*vals, xw)

        return shard_map(
            f, mesh=mesh,
            in_specs=(*vspecs, xspec),
            out_specs=xspec, check_vma=False,
        )(*vals_args, x)

    def tree_flatten(self):
        return (self.inner,), (self.mesh,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0])


def shard_operator(op: LinearOperator, mesh: Mesh) -> LinearOperator:
    """Row-shard an operator's storage and wrap it for mesh execution."""
    if op is None:
        return None
    if isinstance(op, SparseOperator):
        inner = SparseOperator(
            shard_rows(mesh, op.values), shard_rows(mesh, op.indices), op.n_cols
        )
    elif isinstance(op, DiaOperator):
        # DIA stores values as (ndiag, n): the row axis is axis 1
        vals = jax.device_put(
            op.values, NamedSharding(mesh, P(None, ROWS))
        )
        inner = DiaOperator(vals, op.offsets, op.n_cols)
    elif isinstance(op, HybridOperator):
        inner = HybridOperator(
            shard_operator(op.dia, mesh).inner,
            None if op.ell is None else shard_operator(op.ell, mesh).inner,
        )
    elif isinstance(op, DenseOperator):
        inner = DenseOperator(shard_rows(mesh, op.a))
    elif isinstance(op, DiagOperator):
        inner = DiagOperator(shard_rows(mesh, op.d))
    elif isinstance(op, IdentityOperator):
        inner = op
    else:
        raise NotImplementedError(type(op))
    return RowShardedOperator(inner, mesh)
