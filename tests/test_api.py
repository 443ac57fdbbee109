"""One-call frontend (mex analogue) + BGS orthogonalizer + meminfo tests."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps

import gcge_tpu
from tests.conftest import laplacian_1d, laplacian_1d_eigs


def _lap_coo(n):
    a, h = laplacian_1d(n)
    rows, cols = np.nonzero(a)
    return sps.coo_matrix((a[rows, cols], (rows, cols)), shape=(n, n)), h


def test_solve_scipy_standard():
    n = 300
    a, _ = _lap_coo(n)
    ev, vec, nconv = gcge_tpu.solve(a, nev=5, max_iter=100, verbose=0)
    assert nconv >= 5
    np.testing.assert_allclose(ev[:5], laplacian_1d_eigs(n)[:5], rtol=1e-7)
    # residual through scipy
    r = a.tocsr() @ np.asarray(vec)[:, :5] - np.asarray(vec)[:, :5] * ev[:5]
    assert (np.linalg.norm(r, axis=0) / np.abs(ev[:5])).max() < 1e-7


def test_solve_generalized_diag_mass():
    n = 300
    a, h = _lap_coo(n)
    b = np.full(n, h)  # 1-D diagonal -> DiagOperator
    ev, vec, nconv = gcge_tpu.solve(a, b, nev=4, max_iter=100, verbose=0)
    assert nconv >= 4
    np.testing.assert_allclose(ev[:4], laplacian_1d_eigs(n)[:4] / h, rtol=1e-7)


def test_solve_rcm_restores_order():
    """A randomly permuted banded matrix: RCM re-bands it (DIA layout), and
    eigenvectors must come back in the caller's ordering."""
    n = 256
    a, _ = _lap_coo(n)
    rng = np.random.default_rng(3)
    p = rng.permutation(n)
    ps = sps.coo_matrix((np.ones(n), (np.arange(n), p)), shape=(n, n)).tocsr()
    a_perm = (ps @ a.tocsr() @ ps.T).tocoo()
    ev, vec, nconv = gcge_tpu.solve(a_perm, nev=3, rcm=True, max_iter=100,
                                    verbose=0)
    assert nconv >= 3
    np.testing.assert_allclose(ev[:3], laplacian_1d_eigs(n)[:3], rtol=1e-7)
    r = a_perm.tocsr() @ np.asarray(vec)[:, :3] - np.asarray(vec)[:, :3] * ev[:3]
    assert (np.linalg.norm(r, axis=0) / np.abs(ev[:3])).max() < 1e-7


def test_bgs_orth_matches_evp(rng):
    from gcge_tpu.solvers.orth import bgs_orth

    x = jnp.asarray(rng.standard_normal((500, 40)))
    q, rank = bgs_orth(x, leaf=8)
    assert int(rank) == 40
    g = np.asarray(q.T @ q)
    np.testing.assert_allclose(g, np.eye(40), atol=1e-12)


def test_bgs_orth_rank_deficient(rng):
    from gcge_tpu.solvers.orth import bgs_orth

    x = rng.standard_normal((300, 12))
    x[:, 6:] = x[:, :6]  # duplicate half the columns
    q, rank = bgs_orth(jnp.asarray(x), leaf=4)
    assert int(rank) == 6
    qn = np.asarray(q)
    nz = [j for j in range(12) if np.linalg.norm(qn[:, j]) > 1e-8]
    g = qn[:, nz].T @ qn[:, nz]
    np.testing.assert_allclose(g, np.eye(len(nz)), atol=1e-10)


def test_meminfo_snapshot():
    from gcge_tpu.utils.meminfo import MemWatch, snapshot, workspace_bytes

    s = snapshot()
    assert s.num_live_arrays >= 0
    assert workspace_bytes(1000, 10) > 0
    lines = []
    with MemWatch("probe", printer=lines.append):
        keep = jnp.ones((256, 256))
        keep.block_until_ready()
    assert lines and "memwatch" in lines[0]


def test_eigh_jacobi_cpu():
    """Jacobi-polished eigh matches LAPACK on CPU too."""
    from gcge_tpu.ops.eighs import eigh_jacobi

    rng = np.random.default_rng(7)
    a = rng.standard_normal((33, 33))
    a = a + a.T
    w, u = eigh_jacobi(jnp.asarray(a))
    np.testing.assert_allclose(np.asarray(w), np.linalg.eigvalsh(a), atol=1e-11)
    un = np.asarray(u)
    np.testing.assert_allclose(un.T @ un, np.eye(33), atol=1e-12)
    assert np.abs(a @ un - un * np.asarray(w)[None, :]).max() < 1e-10


def test_hybrid_operator_matches_dense(rng):
    """Banded core + outliers: HybridOperator matvec vs dense ground truth."""
    from gcge_tpu.ops.operators import HybridOperator, make_operator

    n = 200
    a = np.zeros((n, n))
    for off, v in ((0, 4.0), (1, -1.0), (-1, -1.0), (5, -0.3), (-5, -0.3)):
        idx = np.arange(max(0, -off), min(n, n - off))
        a[idx, idx + off] = v
    out = rng.integers(0, n, size=(30, 2))          # scattered outliers
    for i, j in out:
        a[i, j] += 0.1
        a[j, i] += 0.1
    rows, cols = np.nonzero(a)
    vals = a[rows, cols]
    op = HybridOperator.from_coo(rows, cols, vals, (n, n), max_diags=5)
    assert op.ell is not None
    x = jnp.asarray(rng.standard_normal((n, 4)))
    np.testing.assert_allclose(np.asarray(op.matvec(x)), a @ np.asarray(x),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(op.to_dense()), a, atol=1e-14)


def test_make_operator_layout_selection(rng):
    from gcge_tpu.ops.operators import (
        DiaOperator, HybridOperator, SparseOperator, make_operator,
    )

    n = 300
    # pure tridiagonal -> DIA
    r = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    c = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    v = np.ones(len(r))
    assert isinstance(make_operator(r, c, v, (n, n)), DiaOperator)
    # tridiagonal + many scattered outlier diagonals -> Hybrid
    oi = rng.integers(0, n - 150, size=40)
    oj = oi + 10 + np.arange(40) % 140
    r2 = np.concatenate([r, oi, oj])
    c2 = np.concatenate([c, oj, oi])
    v2 = np.ones(len(r2))
    op = make_operator(r2, c2, v2, (n, n), max_diags=8)
    assert isinstance(op, HybridOperator)
    d = np.zeros((n, n))
    np.add.at(d, (r2, c2), v2)
    x = rng.standard_normal((n, 3))
    np.testing.assert_allclose(np.asarray(op.matvec(jnp.asarray(x))), d @ x,
                               rtol=1e-11)


def test_safe_eigh_shift_restore():
    """safe_eigh's always-on Tikhonov shift must restore eigenvalues exactly
    (guards the device-eigh NaN failure; see ops/eighs.py)."""
    import numpy as np
    import jax.numpy as jnp
    from gcge_tpu.ops.eighs import safe_eigh

    rng = np.random.default_rng(11)
    # near-singular PSD Gram: eigenvalues spanning 1e-14 .. 2 (the regime
    # where a device eigh can return NaN)
    q, _ = np.linalg.qr(rng.standard_normal((24, 24)))
    d = np.concatenate([np.full(12, 2.0), 10.0 ** rng.uniform(-14, -10, 12)])
    g = (q * d[None, :]) @ q.T
    g = 0.5 * (g + g.T)
    w, u = safe_eigh(jnp.asarray(g))
    w, u = np.asarray(w), np.asarray(u)
    w_ref = np.linalg.eigvalsh(g)
    assert not np.isnan(w).any() and not np.isnan(u).any()
    np.testing.assert_allclose(w, w_ref, atol=1e-11)
    np.testing.assert_allclose(u.T @ u, np.eye(24), atol=1e-11)


def test_solve_distribute_grid(rng):
    """distribute='grid' routes through the 2-D rows x cols mesh."""
    import jax

    if len(jax.devices()) < 8:
        import pytest
        pytest.skip("needs 8 devices")
    import scipy.sparse as sps

    import gcge_tpu

    n = 500
    h = 1.0 / (n + 1)
    a = sps.diags([np.full(n - 1, -1 / h), np.full(n, 2 / h),
                   np.full(n - 1, -1 / h)], [-1, 0, 1]).tocsr()
    ev, vec, nc = gcge_tpu.solve(a, None, nev=5, block_size=3, verbose=0,
                                 distribute="grid")
    k = np.arange(1, 6)
    exact = (2.0 / h) * (1.0 - np.cos(k * np.pi * h))
    assert nc >= 5
    np.testing.assert_allclose(ev[:5], exact, rtol=1e-7)


def test_solve_multigrid_and_pas(rng):
    """One-call AMG-preconditioned GCG and the PAS path."""
    import scipy.sparse as sps

    import gcge_tpu

    n = 800
    h = 1.0 / (n + 1)
    a = sps.diags([np.full(n - 1, -1 / h), np.full(n, 2 / h),
                   np.full(n - 1, -1 / h)], [-1, 0, 1]).tocsr()
    k = np.arange(1, 6)
    exact = (2.0 / h) * (1.0 - np.cos(k * np.pi * h))

    ev, _, nc = gcge_tpu.solve(a, None, nev=5, block_size=3, verbose=0,
                               cg_max_iter=8, multigrid=True)
    assert nc >= 5
    np.testing.assert_allclose(ev[:5], exact, rtol=1e-7)

    ev2, _, nc2 = gcge_tpu.solve(a, None, nev=5, verbose=0, method="pas",
                                 tol_rel=1e-7)
    assert nc2 >= 5
    np.testing.assert_allclose(ev2[:5], exact, rtol=1e-6)


def test_solve_pas_generalized(rng):
    """One-call PAS on a generalized FEM pencil (B on A's pattern)."""
    import scipy.sparse as sps

    import gcge_tpu
    from gcge_tpu.io.fem import cube_fem_laplacian

    rows, cols, a_vals, b_vals, n = cube_fem_laplacian(7)
    a = sps.coo_matrix((a_vals, (rows, cols)), shape=(n, n)).tocsr()
    b = sps.coo_matrix((b_vals, (rows, cols)), shape=(n, n)).tocsr()
    ev, _, nc = gcge_tpu.solve(a, b, nev=3, verbose=0, method="pas",
                               tol_rel=1e-6)
    # oracle: scipy dense generalized eigensolve
    import scipy.linalg

    exact = np.sort(scipy.linalg.eigh(a.toarray(), b.toarray(),
                                      eigvals_only=True))[:3]
    assert nc >= 3
    np.testing.assert_allclose(ev[:3], exact, rtol=1e-5)


def test_eigsh_scipy_compatible(rng):
    """gcge_tpu.eigsh mirrors scipy.sparse.linalg.eigsh for smallest pairs."""
    import scipy.sparse as sps
    import scipy.sparse.linalg as spl

    import gcge_tpu

    n = 400
    h = 1.0 / (n + 1)
    a = sps.diags([np.full(n - 1, -1 / h), np.full(n, 2 / h),
                   np.full(n - 1, -1 / h)], [-1, 0, 1]).tocsr()
    m = sps.diags(np.full(n, h)).tocsr()
    w, v = gcge_tpu.eigsh(a, k=5, M=m, verbose=0)
    w_sp, _ = spl.eigsh(a, k=5, M=m, sigma=0, which="LM")
    np.testing.assert_allclose(w, np.sort(w_sp), rtol=1e-8)
    assert v.shape == (n, 5)
    # residuals in the generalized sense
    r = a @ v - m @ v * w[None, :]
    assert np.abs(r).max() < 1e-5 * np.abs(w).max()
    import pytest
    with pytest.raises(ValueError):
        gcge_tpu.eigsh(a, k=3, which="LM")


def test_api_pas_distributed():
    """api.solve(method='pas', distribute=True): the PAS path must honor
    the mesh (sharded fine level, replicated coarse) — round-1 ignored
    `distribute` for PAS."""
    import scipy.sparse as sps

    from tests.conftest import laplacian_1d, laplacian_1d_eigs

    n, nev = 512, 4
    a, _ = laplacian_1d(n)
    a_s = sps.csr_matrix(a)
    lam, vec, nconv = gcge_tpu.solve(a_s, nev=nev, method="pas", multigrid=3,
                            distribute=True, verbose=0, tol_rel=1e-7,
                            pas_final_sweeps=10, pas_cycles=6)
    assert nconv >= nev
    np.testing.assert_allclose(lam[:nev], laplacian_1d_eigs(n)[:nev],
                               rtol=1e-6)


def test_api_pas_knobs_and_coarse_nev():
    """PAS sweep knobs reach pas_solve, and an explicit coarse_params.nev
    is honored (widened, never silently shrunk)."""
    import scipy.sparse as sps

    from gcge_tpu.solvers.gcg import GCGParams
    from gcge_tpu.solvers.multigrid import build_hierarchy
    from gcge_tpu.solvers.pas import pas_solve
    from tests.conftest import laplacian_1d, laplacian_1d_eigs

    n, nev = 400, 3
    a, _ = laplacian_1d(n)
    rows, cols = np.nonzero(a)
    hier = build_hierarchy(rows, cols, a[rows, cols], n, max_levels=3)
    # explicit wide coarse block: honored
    cp = GCGParams(nev=12, verbose=0, max_iter=300)
    res = pas_solve(hier, nev, coarse_params=cp, verbose=0,
                    final_sweeps=10, bamg_cycles=6, tol_rel=1e-7)
    assert res.nev_conv >= nev
    np.testing.assert_allclose(res.eval, laplacian_1d_eigs(n)[:nev],
                               rtol=1e-6)


def test_cg_mixed_dense_operator_falls_back():
    """cg_mixed with an operator that has no f32 fast path (DenseOperator)
    must run the plain f64 CG instead of asserting (ADVICE r4 high)."""
    import jax.numpy as jnp

    from gcge_tpu.ops.operators import DenseOperator
    from gcge_tpu.solvers.gcg import GCGParams, gcg_solve

    n = 60
    a = np.diag(np.arange(1.0, n + 1))
    res = gcg_solve(DenseOperator(jnp.asarray(a)), None,
                    GCGParams(nev=6, verbose=0, cg_mixed=True, max_iter=60))
    assert res.nev_conv >= 6
    np.testing.assert_allclose(np.asarray(res.eval[:6]),
                               np.arange(1.0, 7.0), rtol=1e-8)
