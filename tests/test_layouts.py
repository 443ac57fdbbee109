"""Sparse layouts and block products against plain references.

DIA and gather-ELL SpMMs against scipy CSR over patterns, dtypes and
multivector widths; ``make_operator``'s choice of layout; the chunked f64
Gram and the tall recombination GEMM against numpy on ill-conditioned
inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps

from gcge_tpu.io.fem import assemble_p1, random_delaunay_mesh
from gcge_tpu.io.stencil import laplacian_27pt
from gcge_tpu.ops.multivec import gram
from gcge_tpu.ops.operators import (DiaOperator, HybridOperator,
                                    SparseOperator, make_operator)


def _band(n, offsets, seed):
    """Random matrix on the given diagonals (square, COO)."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for off in offsets:
        i = np.arange(max(0, -off), min(n, n - off))
        rows.append(i)
        cols.append(i + off)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return sps.coo_matrix((rng.standard_normal(len(rows)), (rows, cols)),
                          shape=(n, n))


def _pattern(name):
    if name == "tridiag":
        return _band(300, (-1, 0, 1), 1)
    if name == "stencil27":
        r, c, v, n = laplacian_27pt(5)
        return sps.coo_matrix((v, (r, c)), shape=(n, n))
    if name == "wide_offsets":
        return _band(257, (-200, -3, 0, 5, 128), 2)
    if name == "single_diag":
        return _band(64, (7,), 3)
    if name == "duplicates":
        # every entry given twice: COO duplicates sum
        a = _band(100, (-2, 0, 3), 4)
        return sps.coo_matrix((np.concatenate([a.data, a.data]),
                               (np.concatenate([a.row, a.row]),
                                np.concatenate([a.col, a.col]))),
                              shape=a.shape)
    raise ValueError(name)


DTYPE_TOL = {jnp.float32: 2e-5, jnp.float64: 1e-13}


@pytest.mark.parametrize("width", [1, 7])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("pattern", ["tridiag", "stencil27", "wide_offsets",
                                     "single_diag", "duplicates"])
def test_dia_matvec_matches_csr(pattern, dtype, width):
    a = _pattern(pattern)
    n = a.shape[0]
    op = DiaOperator.from_coo(a.row, a.col, a.data, a.shape, dtype=dtype)
    x = np.random.default_rng(0).standard_normal((n, width))
    ref = a.tocsr() @ x
    scale = max(np.abs(ref).max(), 1.0)
    y = np.asarray(op.matvec(jnp.asarray(x, dtype)))
    yt = np.asarray(op.matvec_t(jnp.asarray(x.T, dtype))).T
    tol = DTYPE_TOL[dtype]
    np.testing.assert_allclose(y, ref, rtol=tol, atol=tol * scale)
    np.testing.assert_allclose(yt, ref, rtol=tol, atol=tol * scale)
    assert op.nnz == np.count_nonzero(a.toarray())


def _irregular(name):
    if name == "delaunay":
        verts, tets, bnd = random_delaunay_mesh(300, seed=4)
        r, c, av, _, n = assemble_p1(verts, tets, bnd)
        # a random node numbering spreads the mesh's couplings over
        # hundreds of diagonals (the jittered-grid order is banded)
        perm = np.random.default_rng(4).permutation(n)
        return sps.coo_matrix((av, (perm[r], perm[c])), shape=(n, n))
    if name == "empty_rows":
        rng = np.random.default_rng(5)
        n = 200
        r = rng.integers(0, n, 900)
        r = r[r % 3 != 0]                     # every third row empty
        c = rng.integers(0, n, len(r))
        return sps.coo_matrix((rng.standard_normal(len(r)), (r, c)),
                              shape=(n, n))
    if name == "one_dense_row":
        rng = np.random.default_rng(6)
        n = 150
        r = np.concatenate([np.zeros(n, int), np.arange(n)])
        c = np.concatenate([np.arange(n), np.arange(n)])
        return sps.coo_matrix((rng.standard_normal(len(r)), (r, c)),
                              shape=(n, n))
    if name == "rectangular":
        rng = np.random.default_rng(7)
        r = rng.integers(0, 120, 500)
        c = rng.integers(0, 40, 500)
        return sps.coo_matrix((rng.standard_normal(500), (r, c)),
                              shape=(120, 40))
    raise ValueError(name)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("pattern", ["delaunay", "empty_rows",
                                     "one_dense_row", "rectangular"])
def test_ell_matvec_irregular(pattern, dtype):
    """Gather-ELL on irregular patterns: duplicates summed, empty rows give
    zero, padding contributes nothing."""
    a = _irregular(pattern)
    op = SparseOperator.from_coo(a.row, a.col, a.data, a.shape, dtype=dtype)
    assert op.shape == a.shape
    x = np.random.default_rng(1).standard_normal((a.shape[1], 4))
    ref = a.tocsr() @ x
    y = np.asarray(op.matvec(jnp.asarray(x, dtype)))
    tol = DTYPE_TOL[dtype]
    np.testing.assert_allclose(y, ref, rtol=tol,
                               atol=tol * max(np.abs(ref).max(), 1.0))
    np.testing.assert_allclose(np.asarray(op.to_dense()), a.toarray(),
                               rtol=tol, atol=tol)


def _hybrid_pattern():
    """A 121-diagonal banded core plus a thin scatter of outliers on many
    distinct diagonals (too many diagonals for DIA alone)."""
    core = _band(400, tuple(range(-60, 61)), 8).tocoo()
    rng = np.random.default_rng(9)
    r = rng.integers(0, 400, 200)
    c = (r + rng.integers(61, 340, 200)) % 400
    return sps.coo_matrix(
        (np.concatenate([core.data, np.ones(200)]),
         (np.concatenate([core.row, r]), np.concatenate([core.col, c]))),
        shape=(400, 400))


@pytest.mark.parametrize("pattern,layout", [
    ("stencil27", DiaOperator),
    ("tridiag", DiaOperator),
    ("hybrid", HybridOperator),
    ("delaunay", SparseOperator),
    ("rectangular", SparseOperator),
])
def test_make_operator_layout(pattern, layout):
    """make_operator picks DIA for few diagonals, DIA+ELL for a banded core
    with thin outliers, gather-ELL otherwise — and its result applies the
    same matrix."""
    if pattern == "hybrid":
        a = _hybrid_pattern()
    elif pattern in ("stencil27", "tridiag"):
        a = _pattern(pattern)
    else:
        a = _irregular(pattern)
    op = make_operator(a.row, a.col, a.data, a.shape)
    assert type(op) is layout
    x = np.random.default_rng(2).standard_normal((a.shape[1], 3))
    np.testing.assert_allclose(np.asarray(op.matvec(jnp.asarray(x))),
                               a.tocsr() @ x, rtol=1e-12, atol=1e-12)


def _hard(name, n=20000, m=12, seed=0):
    rng = np.random.default_rng(seed)
    if name == "correlated":
        # columns sharing one dominant direction: a large, strongly
        # correlated Gram diagonal (x^T x of nearly parallel columns)
        base = rng.standard_normal((n, 1))
        return base + 1e-3 * rng.standard_normal((n, m))
    if name == "near_orthonormal":
        q, _ = np.linalg.qr(rng.standard_normal((n, m)))
        return q + 1e-9 * rng.standard_normal((n, m))
    if name == "wide_range":
        x = rng.standard_normal((n, m))
        return x * (10.0 ** np.linspace(-8, 8, m))[None, :]
    raise ValueError(name)


@pytest.mark.parametrize("name", ["correlated", "near_orthonormal",
                                  "wide_range"])
def test_gram_f64_hard_inputs(name):
    """The chunked f64 Gram matches a float128-accumulated reference to
    f64 rounding, entry by entry relative to the operands' norms."""
    x = _hard(name)
    y = _hard(name, seed=1)
    g = np.asarray(gram(jnp.asarray(x), jnp.asarray(y)))
    ref = (x.astype(np.longdouble).T @ y.astype(np.longdouble)).astype(
        np.float64)
    norms = np.linalg.norm(x, axis=0)[:, None] * np.linalg.norm(y, axis=0)
    assert np.max(np.abs(g - ref) / norms) < 1e-14


@pytest.mark.parametrize("name", ["correlated", "near_orthonormal",
                                  "wide_range"])
def test_expand_f64_hard_inputs(name):
    """The tall recombination V @ C (Ritz vectors, P expansion) in f64."""
    v = _hard(name, n=5000)
    c = np.random.default_rng(3).standard_normal((v.shape[1], 5))
    y = np.asarray(jnp.asarray(v) @ jnp.asarray(c))
    ref = (v.astype(np.longdouble) @ c.astype(np.longdouble)).astype(
        np.float64)
    bound = np.abs(v) @ np.abs(c)
    assert np.max(np.abs(y - ref) / bound) < 1e-14
