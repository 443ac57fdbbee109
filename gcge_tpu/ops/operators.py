"""Linear operators — the re-design of the reference's backend layer.

The reference dispatches matrix kinds through an ``OPS_`` vtable filled by one
of seven backends (``/root/reference/app/``).  Here an operator is a pytree
object with a single method ``matvec(X) -> A @ X`` acting on multivectors of
shape ``(n, m)``; solvers are generic over it and everything jits.

* :class:`DenseOperator`   — dense symmetric matrix (app_lapack analogue).
* :class:`SparseOperator`  — ELL-packed sparse matrix (app_ccs analogue);
  ``matvec`` is a gather-SpMM.
* :class:`DiaOperator`     — diagonal (DIA) storage; ``matvec`` is a
  gather-free shift-and-FMA.
* :class:`HybridOperator`  — DIA core plus a thin ELL remainder.
* :class:`DiagOperator`    — diagonal (mass) matrix.
* :class:`IdentityOperator`— B = I for standard problems.
* :class:`ShiftedOperator` — ``A + sigma*B`` represented functionally, the
  analogue of ``MatDotMultiVecShift``
  (``/root/reference/src/ops_eig_sol_gcg.c:63-96``): no in-place
  ``A <- A + sigma B`` mutation is ever needed under XLA.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


class LinearOperator:
    """Protocol: symmetric linear operator on multivectors ``(n, m)``."""

    shape: tuple[int, int]

    def matvec(self, x: jax.Array) -> jax.Array:  # pragma: no cover - protocol
        raise NotImplementedError

    def __call__(self, x: jax.Array) -> jax.Array:
        return self.matvec(x)


@jax.tree_util.register_pytree_node_class
class DenseOperator(LinearOperator):
    """Dense symmetric operator; matvec is one GEMM."""

    def __init__(self, a: jax.Array):
        self.a = a

    @property
    def shape(self):
        return self.a.shape

    @property
    def dtype(self):
        return self.a.dtype

    def matvec(self, x):
        return self.a @ x

    def tree_flatten(self):
        return (self.a,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
class DiagOperator(LinearOperator):
    """Diagonal operator (e.g. lumped mass matrix)."""

    def __init__(self, d: jax.Array):
        self.d = d

    @property
    def shape(self):
        return (self.d.shape[0], self.d.shape[0])

    @property
    def dtype(self):
        return self.d.dtype

    def matvec(self, x):
        return self.d[:, None] * x

    def tree_flatten(self):
        return (self.d,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
class IdentityOperator(LinearOperator):
    """B = I for standard eigenproblems ``A x = lambda x``."""

    def __init__(self, n: int, dtype=jnp.float64):
        self.n = int(n)
        self._dtype = dtype

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self._dtype

    def matvec(self, x):
        return x

    def tree_flatten(self):
        return (), (self.n, self._dtype)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(aux[0], aux[1])


@jax.tree_util.register_pytree_node_class
class ShiftedOperator(LinearOperator):
    """``(A + sigma * B) x`` without mutating A.

    ``sigma`` is a traced scalar so auto-shift changes per GCG iteration
    never recompile.  Reference: ``MatDotMultiVecShift``
    (``/root/reference/src/ops_eig_sol_gcg.c:63-96``).
    """

    def __init__(self, a: LinearOperator, b: LinearOperator | None, sigma):
        self.a = a
        self.b = b
        self.sigma = sigma

    @property
    def shape(self):
        return self.a.shape

    @property
    def dtype(self):
        return self.a.dtype

    def matvec(self, x):
        y = self.a.matvec(x)
        bx = x if self.b is None else self.b.matvec(x)
        return y + self.sigma * bx

    def tree_flatten(self):
        return (self.a, self.b, self.sigma), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
class FunctionOperator(LinearOperator):
    """Matrix-free symmetric operator from a jit-traceable multivector
    function ``fn(x: (n, m)) -> (n, m)``.

    The analogue of filling the reference's OPS vtable with a custom
    ``MatDotMultiVec`` (``ops.h:84``) without materializing the matrix —
    e.g. stencils applied as shifts, FFT-diagonalizable operators, or
    operator compositions.  ``fn`` must be a pure function (it is carried as
    static pytree metadata, so using the same ``fn`` object avoids
    recompiles)."""

    def __init__(self, fn, n: int, dtype=jnp.float64):
        self.fn = fn
        self.n = int(n)
        self._dtype = dtype

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self._dtype

    def matvec(self, x):
        return self.fn(x)

    def tree_flatten(self):
        return (), (self.fn, self.n, self._dtype)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(aux[0], aux[1], aux[2])


def _ell_spmm(values: jax.Array, indices: jax.Array, x: jax.Array) -> jax.Array:
    """ELL SpMM: ``y[i, :] = sum_k values[i, k] * x[indices[i, k], :]``.

    Row-wise gather formulation; padded entries carry ``values == 0`` and
    ``indices`` pointing at row 0 so they contribute nothing.  Unrolled over
    the (static, small) ELL width so XLA fuses the gather + FMA chain; memory
    traffic is ``kmax`` passes over ``x`` worst-case, mostly served from
    cache.
    """
    kmax = values.shape[1]

    def body(k, y):
        xg = jnp.take(x, indices[:, k], axis=0)
        return y + values[:, k][:, None] * xg

    y0 = jnp.zeros((values.shape[0], x.shape[1]), dtype=x.dtype)
    return jax.lax.fori_loop(0, kmax, body, y0, unroll=4)


@jax.tree_util.register_pytree_node_class
class SparseOperator(LinearOperator):
    """Symmetric sparse operator in ELL (padded-row) layout.

    The replacement for the reference's CCS backend
    (``/root/reference/app/app_ccs.c:50-139``): instead of a scalar CSC loop,
    rows are padded to the max row length so the SpMM is a static-shape
    gather + FMA pipeline — no dynamic sparsity structure inside jit.
    """

    def __init__(self, values: jax.Array, indices: jax.Array, n_cols: int):
        self.values = values      # (n_rows, kmax) nonzero values, zero-padded
        self.indices = indices    # (n_rows, kmax) column indices, 0-padded
        self.n_cols = int(n_cols)

    @property
    def shape(self):
        return (self.values.shape[0], self.n_cols)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def nnz(self):
        return int(np.asarray(jnp.count_nonzero(self.values)))

    def matvec(self, x):
        return _ell_spmm(self.values, self.indices, x)

    def tree_flatten(self):
        return (self.values, self.indices), (self.n_cols,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux[0])

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_coo(cls, rows, cols, vals, shape, dtype=jnp.float64):
        """Pack COO triplets to ELL on host (numpy), then device-put."""
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals)
        n_rows, n_cols = shape
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        counts = np.bincount(rows, minlength=n_rows)
        kmax = max(int(counts.max()), 1)
        values = np.zeros((n_rows, kmax), dtype=np.dtype(jnp.dtype(dtype).name))
        indices = np.zeros((n_rows, kmax), dtype=np.int32)
        # position of each nnz within its row
        row_start = np.zeros(n_rows + 1, dtype=np.int64)
        np.cumsum(counts, out=row_start[1:])
        pos = np.arange(len(rows)) - row_start[rows]
        values[rows, pos] = vals
        indices[rows, pos] = cols
        return cls(jnp.asarray(values), jnp.asarray(indices), n_cols)

    @classmethod
    def from_scipy(cls, mat, dtype=jnp.float64):
        coo = mat.tocoo()
        return cls.from_coo(coo.row, coo.col, coo.data, coo.shape, dtype=dtype)

    def to_dense(self):
        n, _ = self.shape
        out = jnp.zeros((n, self.n_cols), dtype=self.dtype)
        rows = jnp.repeat(jnp.arange(n), self.values.shape[1])
        return out.at[rows, self.indices.reshape(-1)].add(self.values.reshape(-1))


@jax.tree_util.register_pytree_node_class
class DiaOperator(LinearOperator):
    """Sparse operator in DIA (diagonal) layout — the gather-free fast path.

    ``y[i] = sum_d values[d, i] * x[i + offsets[d]]`` with *static* diagonal
    offsets: each term is a shift (pad + slice) and an FMA — no gathers at
    all, so XLA fuses the whole sum into one elementwise pass.  This is the
    answer to stencil/banded matrices — FEM Laplacians on structured meshes,
    and general matrices after RCM bandwidth reduction whose nonzeros
    concentrate on few diagonals.  Replaces the scalar CSC loop of the
    reference's CCS backend (``/root/reference/app/app_ccs.c:116-131``) for
    this matrix class.
    """

    def __init__(self, values: jax.Array, offsets: tuple[int, ...], n_cols: int):
        self.values = values          # (ndiag, n_rows); values[d, i] = A[i, i+off_d]
        self.offsets = tuple(int(o) for o in offsets)
        self.n_cols = int(n_cols)

    @property
    def shape(self):
        return (self.values.shape[1], self.n_cols)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def nnz(self):
        return int(np.asarray(jnp.count_nonzero(self.values)))

    def matvec(self, x):
        n = self.values.shape[1]
        m = x.shape[1]
        y = jnp.zeros((n, m), x.dtype)
        zero_row = jnp.zeros((1, m), x.dtype)
        for d, off in enumerate(self.offsets):
            if off == 0:
                xs = x
            elif off > 0:
                pad = jnp.broadcast_to(zero_row, (min(off, n), m))
                xs = jnp.concatenate([x[off:], pad], axis=0)[:n]
            else:
                pad = jnp.broadcast_to(zero_row, (min(-off, n), m))
                xs = jnp.concatenate([pad, x[: n + off]], axis=0)[:n]
            y = y + self.values[d][:, None] * xs
        return y

    def tree_flatten(self):
        return (self.values,), (self.offsets, self.n_cols)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0], aux[1])

    @classmethod
    def from_coo(cls, rows, cols, vals, shape, dtype=jnp.float64):
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals)
        n_rows, n_cols = shape
        offs = cols - rows
        uniq = np.unique(offs)
        values = np.zeros((len(uniq), n_rows), dtype=np.dtype(jnp.dtype(dtype).name))
        d_idx = np.searchsorted(uniq, offs)
        np.add.at(values, (d_idx, rows), vals)    # duplicates sum, as in COO
        return cls(jnp.asarray(values), tuple(uniq.tolist()), n_cols)

    def matvec_t(self, xt):
        """Transposed-layout matvec: ``xt (m, n) -> (A @ x)^T (m, n)``.

        Same shift-and-FMA formulation with the row index on the LAST axis —
        the layout of transposed hot loops (the mixed-precision inner CG),
        avoiding per-matvec transposes.
        """
        n = self.values.shape[1]
        m = xt.shape[0]
        y = jnp.zeros((m, n), xt.dtype)
        zero_col = jnp.zeros((m, 1), xt.dtype)
        for d, off in enumerate(self.offsets):
            if off == 0:
                xs = xt
            elif off > 0:
                pad = jnp.broadcast_to(zero_col, (m, min(off, n)))
                xs = jnp.concatenate([xt[:, off:], pad], axis=1)[:, :n]
            else:
                pad = jnp.broadcast_to(zero_col, (m, min(-off, n)))
                xs = jnp.concatenate([pad, xt[:, : n + off]], axis=1)[:, :n]
            y = y + self.values[d][None, :] * xs
        return y

    def to_dense(self):
        n = self.values.shape[1]
        out = jnp.zeros((n, self.n_cols), dtype=self.dtype)
        rows = np.arange(n)
        for d, off in enumerate(self.offsets):
            cols = rows + off
            ok = (cols >= 0) & (cols < self.n_cols)
            out = out.at[rows[ok], cols[ok]].add(self.values[d, rows[ok]])
        return out

    @staticmethod
    def n_diagonals(rows, cols) -> int:
        return len(np.unique(np.asarray(cols) - np.asarray(rows)))


@jax.tree_util.register_pytree_node_class
class HybridOperator(LinearOperator):
    """DIA core + ELL remainder — the general-matrix fast path.

    Most irregular symmetric matrices become *almost* banded after RCM
    reordering (``native/matpack.cpp``): the overwhelming share of nonzeros
    lands on a few hundred diagonals, with a thin scatter of outliers.
    Storing the dominant diagonals in the gather-free DIA layout and only
    the leftovers in a (narrow) gather-ELL keeps the SpMM an order of
    magnitude faster than all-ELL while staying exact.  This replaces the
    reference's one-size CSC SpMM (``/root/reference/app/app_ccs.c:50-139``)
    with a structure-adaptive split."""

    def __init__(self, dia: DiaOperator, ell: SparseOperator | None):
        self.dia = dia
        self.ell = ell

    @property
    def shape(self):
        return self.dia.shape

    @property
    def dtype(self):
        return self.dia.dtype

    @property
    def nnz(self):
        return self.dia.nnz + (0 if self.ell is None else self.ell.nnz)

    def matvec(self, x):
        y = self.dia.matvec(x)
        if self.ell is not None:
            y = y + self.ell.matvec(x)
        return y

    def to_dense(self):
        d = self.dia.to_dense()
        return d if self.ell is None else d + self.ell.to_dense()

    def tree_flatten(self):
        return (self.dia, self.ell), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @classmethod
    def from_coo(cls, rows, cols, vals, shape, dtype=jnp.float64,
                 max_diags: int = 128):
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals)
        offs = cols - rows
        uniq, counts = np.unique(offs, return_counts=True)
        keep = uniq[np.argsort(-counts)[:max_diags]]
        in_dia = np.isin(offs, keep)
        dia = DiaOperator.from_coo(
            rows[in_dia], cols[in_dia], vals[in_dia], shape, dtype=dtype)
        ell = None
        if (~in_dia).any():
            ell = SparseOperator.from_coo(
                rows[~in_dia], cols[~in_dia], vals[~in_dia], shape, dtype=dtype)
        return cls(dia, ell)


def make_operator(rows, cols, vals, shape, dtype=jnp.float64,
                  max_diags: int = 128, hybrid_cover: float = 0.85,
                  hybrid_max_ell_width: int = 8):
    """Pick the best sparse layout for the pattern:

    * **DIA** when everything sits on few diagonals (stencils, RCM-banded);
    * **Hybrid** (DIA core + ELL outliers) when the top ``max_diags``
      diagonals cover ``hybrid_cover`` of the nonzeros and the remainder is
      a thin ELL;
    * **ELL** otherwise.
    """
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    if shape[0] != shape[1]:
        # DIA/Hybrid shift semantics assume a square operator; rectangular
        # matrices (multigrid transfer P) stay in the gather-ELL layout
        return SparseOperator.from_coo(rows, cols, vals, shape, dtype=dtype)
    offs = cols - rows
    uniq, counts = np.unique(offs, return_counts=True)
    if len(uniq) <= max_diags:
        return DiaOperator.from_coo(rows, cols, vals, shape, dtype=dtype)
    order = np.argsort(-counts)
    covered = counts[order[:max_diags]].sum() / max(len(offs), 1)
    if covered >= hybrid_cover:
        out = ~np.isin(offs, uniq[order[:max_diags]])
        width = np.bincount(rows[out], minlength=shape[0]).max() if out.any() else 0
        if width <= hybrid_max_ell_width:
            return HybridOperator.from_coo(rows, cols, vals, shape,
                                           dtype=dtype, max_diags=max_diags)
    # genuinely irregular pattern: gather-ELL
    return SparseOperator.from_coo(rows, cols, vals, shape, dtype=dtype)
