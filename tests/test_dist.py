"""Distributed (row-sharded) path tests on the 8-virtual-device CPU mesh.

The stand-in for the reference's cluster runs (``test/submit.sh``): the same
solves must produce the same answers when A/B/multivectors are row-partitioned
over a mesh — the reference's determinism requirement
(``ops_eig_sol_gcg.c:1085-1088``: every rank must own identical eigenvectors)
holds by construction here because the projected problem is replicated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gcge_tpu.ops.operators import DenseOperator, DiagOperator, SparseOperator
from gcge_tpu.parallel import pad_problem, row_mesh, shard_operator, shard_rows
from gcge_tpu.solvers.bpcg import BlockPCGParams, block_pcg
from gcge_tpu.solvers.gcg import GCGParams, gcg_solve
from tests.conftest import laplacian_1d, laplacian_1d_eigs


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices (the CPU virtual mesh)")
    return row_mesh(8)


def test_sharded_spmm_matches_local(mesh, rng):
    n = 512
    a, _ = laplacian_1d(n)
    rows, cols = np.nonzero(a)
    sp = SparseOperator.from_coo(rows, cols, a[rows, cols], a.shape)
    sp_d = shard_operator(sp, mesh)
    x = jnp.asarray(rng.standard_normal((n, 5)))
    y_local = np.asarray(sp.matvec(x))
    y_dist = np.asarray(sp_d.matvec(shard_rows(mesh, x)))
    np.testing.assert_allclose(y_dist, y_local, rtol=1e-13)


def test_sharded_dense_matches_local(mesh, rng):
    n = 256
    a = rng.standard_normal((n, n))
    a = a + a.T
    op = DenseOperator(jnp.asarray(a))
    op_d = shard_operator(op, mesh)
    x = jnp.asarray(rng.standard_normal((n, 3)))
    np.testing.assert_allclose(
        np.asarray(op_d.matvec(shard_rows(mesh, x))),
        np.asarray(op.matvec(x)),
        rtol=1e-12,
    )


def test_sharded_bpcg(mesh, rng):
    n = 512
    a, _ = laplacian_1d(n)
    rows, cols = np.nonzero(a)
    sp_d = shard_operator(SparseOperator.from_coo(rows, cols, a[rows, cols], a.shape), mesh)
    x_true = rng.standard_normal((n, 3))
    b = shard_rows(mesh, jnp.asarray(a @ x_true))
    params = BlockPCGParams(max_iter=800, rate=0.0, tol=1e-12, tol_type="rel")
    x, info = block_pcg(sp_d.matvec, b, jnp.zeros((n, 3)), params)
    np.testing.assert_allclose(np.asarray(x), x_true, rtol=1e-6, atol=1e-8)


def test_distributed_gcg_matches_single(mesh):
    """Full GCG on the mesh must match the single-device solve."""
    n, nev = 512, 8
    a, _ = laplacian_1d(n)
    rows, cols = np.nonzero(a)
    sp = SparseOperator.from_coo(rows, cols, a[rows, cols], a.shape)
    exact = laplacian_1d_eigs(n)
    params = GCGParams(nev=nev, block_size=3, max_iter=60, verbose=0)

    res_local = gcg_solve(sp, None, params)
    res_dist = gcg_solve(shard_operator(sp, mesh), None, params, mesh=mesh)

    assert res_dist.nev_conv >= nev
    np.testing.assert_allclose(res_dist.eval[:nev], exact[:nev], rtol=1e-7)
    np.testing.assert_allclose(res_dist.eval[:nev], res_local.eval[:nev], rtol=1e-9)


def test_distributed_gcg_generalized_padded(mesh):
    """n not divisible by the mesh: pad_problem keeps the smallest pairs."""
    n, nev = 403, 6  # 403 = 13*31, not divisible by 8
    a, h = laplacian_1d(n)
    rows, cols = np.nonzero(a)
    sp = SparseOperator.from_coo(rows, cols, a[rows, cols], a.shape)
    b = DiagOperator(jnp.full(n, h))
    exact = laplacian_1d_eigs(n) / h

    a_pad, b_pad, n_orig = pad_problem(sp, b, 8)
    assert a_pad.shape[0] % 8 == 0 and n_orig == n
    params = GCGParams(nev=nev, block_size=3, max_iter=60, verbose=0)
    res = gcg_solve(
        shard_operator(a_pad, mesh), shard_operator(b_pad, mesh), params, mesh=mesh
    )
    assert res.nev_conv >= nev
    np.testing.assert_allclose(res.eval[:nev], exact[:nev], rtol=1e-7)


def test_sharded_dia_halo_matches_local(mesh, rng):
    """Banded (DIA) distributed SpMM with neighbor-halo ppermute exchange."""
    from gcge_tpu.ops.operators import DiaOperator

    n = 512  # 64 rows per device; band fits in a local block
    a, _ = laplacian_1d(n)
    rows, cols = np.nonzero(a)
    dia = DiaOperator.from_coo(rows, cols, a[rows, cols], a.shape)
    dia_d = shard_operator(dia, mesh)
    x = jnp.asarray(rng.standard_normal((n, 5)))
    np.testing.assert_allclose(
        np.asarray(dia_d.matvec(shard_rows(mesh, x))),
        np.asarray(dia.matvec(x)),
        rtol=1e-13,
    )


def test_sharded_dia_wide_band_fallback(mesh, rng):
    """Band wider than the local block -> all-gather + window fallback."""
    from gcge_tpu.ops.operators import DiaOperator

    n = 64  # 8 rows/device; offsets up to +-16 exceed the local block
    d = rng.standard_normal(n) + 10.0
    rows = [np.arange(n)]
    cols = [np.arange(n)]
    vals = [d]
    for off in (16, -16):
        r = np.arange(max(0, -off), min(n, n - off))
        rows.append(r)
        cols.append(r + off)
        vals.append(np.full(len(r), -1.0))
    rows, cols, vals = map(np.concatenate, (rows, cols, vals))
    dia = DiaOperator.from_coo(rows, cols, vals, (n, n))
    dia_d = shard_operator(dia, mesh)
    x = jnp.asarray(rng.standard_normal((n, 3)))
    np.testing.assert_allclose(
        np.asarray(dia_d.matvec(shard_rows(mesh, x))),
        np.asarray(dia.matvec(x)),
        rtol=1e-13,
    )


def test_distributed_gcg_dia(mesh):
    """Full distributed GCG over the halo-exchange DIA path."""
    from gcge_tpu.ops.operators import DiaOperator

    n = 512
    a, h = laplacian_1d(n)
    rows, cols = np.nonzero(a)
    dia_d = shard_operator(
        DiaOperator.from_coo(rows, cols, a[rows, cols], a.shape), mesh
    )
    p = GCGParams(nev=6, block_size=3, max_iter=100, verbose=0)
    res = gcg_solve(dia_d, None, p, mesh=mesh)
    exact = laplacian_1d_eigs(n)[:6]
    assert res.nev_conv >= 6
    np.testing.assert_allclose(res.eval[:6], exact, rtol=1e-7)


def test_sharded_hybrid_matches_local(mesh, rng):
    """Hybrid (DIA halo + ELL all-gather) distributed matvec."""
    from gcge_tpu.ops.operators import HybridOperator

    n = 512
    a, _ = laplacian_1d(n)
    # add scattered symmetric outliers
    oi = rng.integers(0, n // 2, size=40)
    oj = oi + n // 3
    a[oi, oj] += 0.5
    a[oj, oi] += 0.5
    rows, cols = np.nonzero(a)
    op = HybridOperator.from_coo(rows, cols, a[rows, cols], a.shape,
                                 max_diags=3)
    assert op.ell is not None
    op_d = shard_operator(op, mesh)
    x = jnp.asarray(rng.standard_normal((n, 4)))
    np.testing.assert_allclose(
        np.asarray(op_d.matvec(shard_rows(mesh, x))),
        np.asarray(op.matvec(x)),
        rtol=1e-13,
    )


def test_pad_problem_generalized_sparse_mass(mesh, rng):
    """pad_problem with a DIA/sparse mass matrix: padded pencil eigenvalues
    sort last and the distributed generalized solve matches single-device."""
    from gcge_tpu.io.fem import cube_fem_laplacian
    from gcge_tpu.ops.operators import make_operator

    rows, cols, a_vals, b_vals, n = cube_fem_laplacian(5)  # n=64 -> pads to 64? no: 4^3=64
    a_op = make_operator(rows, cols, a_vals, (n, n))
    b_op = make_operator(rows, cols, b_vals, (n, n))
    p = GCGParams(nev=3, block_size=2, max_iter=120, verbose=0)
    ref = gcg_solve(a_op, b_op, p)
    a_pad, b_pad, n0 = pad_problem(a_op, b_op, 8)
    assert a_pad.shape[0] % 8 == 0 and n0 == n
    a_d = shard_operator(a_pad, mesh)
    b_d = shard_operator(b_pad, mesh)
    res = gcg_solve(a_d, b_d, p, mesh=mesh)
    assert res.nev_conv >= 3
    np.testing.assert_allclose(res.eval[:3], ref.eval[:3], rtol=1e-8)


# ---------------------------------------------------------------------------
# 2-D (rows x cols) meshes and multi-host ingestion helpers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh2d():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices (the CPU virtual mesh)")
    from gcge_tpu.parallel import grid_mesh

    return grid_mesh(4, 2)


def test_grid_mesh_spmm_matches_local(mesh2d, rng):
    from gcge_tpu.ops.operators import DiaOperator
    from gcge_tpu.parallel import shard_mv

    n = 512
    a, _ = laplacian_1d(n)
    rows, cols = np.nonzero(a)
    dia = DiaOperator.from_coo(rows, cols, a[rows, cols], a.shape)
    dia_d = shard_operator(dia, mesh2d)
    x = jnp.asarray(rng.standard_normal((n, 6)))
    np.testing.assert_allclose(
        np.asarray(dia_d.matvec(shard_mv(mesh2d, x))),
        np.asarray(dia.matvec(x)), rtol=1e-13)
    # ELL path too (all-gather over rows, cols stay sharded)
    sp = SparseOperator.from_coo(rows, cols, a[rows, cols], a.shape)
    sp_d = shard_operator(sp, mesh2d)
    np.testing.assert_allclose(
        np.asarray(sp_d.matvec(shard_mv(mesh2d, x))),
        np.asarray(sp.matvec(x)), rtol=1e-13)


def test_distributed_gcg_grid_mesh(mesh2d):
    """Full GCG over a 2-D mesh: basis sharded over rows AND columns —
    the huge-nev layout (ROADMAP '2-D meshes')."""
    n = 512
    a, _ = laplacian_1d(n)
    rows, cols = np.nonzero(a)
    sp_d = shard_operator(
        SparseOperator.from_coo(rows, cols, a[rows, cols], a.shape), mesh2d)
    params = GCGParams(nev=8, block_size=4, tol_rel=1e-9, verbose=0)
    res = gcg_solve(sp_d, None, params, mesh=mesh2d)
    exact = laplacian_1d_eigs(n)[:8]
    assert res.nev_conv >= 8
    np.testing.assert_allclose(res.eval[:8], exact, rtol=1e-8)


def test_multihost_ingestion_single_process(mesh, rng):
    """Per-host block assembly helpers in the process_count == 1 limit:
    the 'local block' is all rows, and the assembled arrays must equal
    direct sharding."""
    from gcge_tpu.parallel import (dia_from_host_blocks, ell_from_host_blocks,
                                   hybrid_row_mesh, mv_from_host_blocks)

    n = 256
    a, _ = laplacian_1d(n)
    rows, cols = np.nonzero(a)
    vals = a[rows, cols]
    from gcge_tpu.ops.operators import DiaOperator, SparseOperator as Ell

    dia_ref = DiaOperator.from_coo(rows, cols, vals, a.shape)
    ell_ref = Ell.from_coo(rows, cols, vals, a.shape)

    hm = hybrid_row_mesh()
    assert hm.shape["rows"] == len(jax.devices())

    dia_d = dia_from_host_blocks(mesh, np.asarray(dia_ref.values),
                                 dia_ref.offsets, n)
    ell_d = ell_from_host_blocks(mesh, np.asarray(ell_ref.values),
                                 np.asarray(ell_ref.indices), n)
    x = rng.standard_normal((n, 4))
    xd = mv_from_host_blocks(mesh, x, n)
    y_ref = np.asarray(dia_ref.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(np.asarray(dia_d.matvec(xd)), y_ref, rtol=1e-13)
    np.testing.assert_allclose(np.asarray(ell_d.matvec(xd)), y_ref, rtol=1e-13)

    # end-to-end: solve from host blocks
    res = gcg_solve(dia_d, None,
                    GCGParams(nev=4, block_size=2, tol_rel=1e-9, verbose=0),
                    mesh=mesh)
    np.testing.assert_allclose(res.eval[:4], laplacian_1d_eigs(n)[:4],
                               rtol=1e-8)


def test_bootstrap_single_process():
    from gcge_tpu.parallel import bootstrap

    pid, pcount = bootstrap()
    assert pid == 0 and pcount == 1


# ---------------------------------------------------------------------------
# distributed multigrid (sharded fine level, replicated coarse levels)
# ---------------------------------------------------------------------------


def test_distributed_bamg_matches_local(mesh, rng):
    from gcge_tpu.parallel.dist_mg import shard_hierarchy
    from gcge_tpu.solvers.multigrid import bamg_solve, build_hierarchy

    n = 512
    a, _ = laplacian_1d(n)
    rows, cols = np.nonzero(a)
    hier = build_hierarchy(rows, cols, a[rows, cols], n, max_levels=3)
    hier_d = shard_hierarchy(hier, mesh)

    x_true = rng.standard_normal((n, 4))
    b = jnp.asarray(a @ x_true)
    x_loc, it_l, rel_l = bamg_solve(hier, b, max_cycles=25, rtol=1e-10)
    x_dist, it_d, rel_d = bamg_solve(hier_d, shard_rows(mesh, b),
                                     max_cycles=25, rtol=1e-10)
    assert float(np.max(np.asarray(rel_d))) < 1e-10
    np.testing.assert_allclose(np.asarray(x_dist), x_true, atol=1e-7)
    # same algorithm on both layouts: identical cycle counts
    assert it_d == it_l
    # Chebyshev smoothing (zero smoother collectives) also works distributed
    x_ch, _, rel_ch = bamg_solve(hier_d, shard_rows(mesh, b), max_cycles=30,
                                 rtol=1e-10, smoother="chebyshev")
    assert float(np.max(np.asarray(rel_ch))) < 1e-10
    # rtol 1e-10 on the residual bounds the error by ~||b||*rtol/lam_min
    np.testing.assert_allclose(np.asarray(x_ch), x_true, atol=1e-6)


def test_distributed_gcg_with_bamg_preconditioner(mesh):
    """Distributed GCG + distributed AMG-preconditioned inner CG — the full
    reference stack (GCG + BAMG over MPI) on a mesh."""
    from gcge_tpu.parallel.dist_mg import shard_hierarchy
    from gcge_tpu.solvers.multigrid import bamg_preconditioner, build_hierarchy

    n = 512
    a, _ = laplacian_1d(n)
    rows, cols = np.nonzero(a)
    vals = a[rows, cols]
    hier_d = shard_hierarchy(
        build_hierarchy(rows, cols, vals, n, max_levels=3), mesh)
    op = shard_operator(SparseOperator.from_coo(rows, cols, vals, a.shape),
                        mesh)
    params = GCGParams(nev=5, block_size=3, verbose=0, cg_max_iter=8,
                       tol_rel=1e-9,
                       linear_precond=bamg_preconditioner(hier_d))
    res = gcg_solve(op, None, params, mesh=mesh)
    assert res.nev_conv >= 5
    np.testing.assert_allclose(res.eval[:5], laplacian_1d_eigs(n)[:5],
                               rtol=1e-8)


def test_distributed_pas(mesh):
    """Multilevel PAS on a distributed hierarchy: coarse GCG replicated,
    fine-level corrections and augmented RR sharded — the reference's full
    multilevel stack (PAS + BAMG + GCG over MPI) on a mesh."""
    from gcge_tpu.parallel.dist_mg import shard_hierarchy
    from gcge_tpu.solvers.multigrid import build_hierarchy
    from gcge_tpu.solvers.pas import pas_solve

    n, nev = 512, 4
    a, _ = laplacian_1d(n)
    rows, cols = np.nonzero(a)
    hier_d = shard_hierarchy(
        build_hierarchy(rows, cols, a[rows, cols], n, max_levels=3), mesh)
    res = pas_solve(hier_d, nev, verbose=0, final_sweeps=10, bamg_cycles=6,
                    tol_rel=1e-7)
    assert res.nev_conv >= nev
    np.testing.assert_allclose(res.eval, laplacian_1d_eigs(n)[:nev],
                               rtol=1e-6)


def test_sharded_eigh_newton(mesh, rng):
    """Mesh-sharded projected eigensolve — the spectrum-sliced-dsyevx
    analogue (``ops_eig_sol_gcg.c:1084-1189``): the Newton refinement's
    O(m^3) work is partitioned over the devices, and the result must match
    the replicated solve (the reference's determinism requirement)."""
    from gcge_tpu.ops.eighs import eigh_newton

    m = 192
    lam = np.sort(rng.uniform(0.5, 50.0, m))
    lam[40:44] = lam[40]            # a degenerate cluster for stage 2
    q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    h = jnp.asarray(q * lam[None, :] @ q.T)
    h = 0.5 * (h + h.T)

    # a noisy warm start so the refinement has work to do
    w0, u0 = np.linalg.eigh(np.asarray(h))
    u0 = u0 + 3e-7 * rng.standard_normal((m, m)) * np.abs(lam).max() ** 0.5
    warm = (jnp.asarray(w0), jnp.asarray(u0))

    w_s, u_s = eigh_newton(h, warm=warm, mesh=mesh)
    w_r, u_r = eigh_newton(h, warm=warm)
    hn = np.asarray(h)
    resid = np.linalg.norm(
        hn @ np.asarray(u_s) - np.asarray(u_s) * np.asarray(w_s)[None, :],
        axis=0).max() / np.abs(lam).max()
    assert resid < 1e-9, resid
    np.testing.assert_allclose(np.asarray(w_s), np.sort(lam), rtol=1e-10)
    # sharded and replicated paths agree to rounding
    np.testing.assert_allclose(np.asarray(w_s), np.asarray(w_r), rtol=1e-12)


def test_distributed_gcg_newton_rr(mesh):
    """Distributed GCG with the (sharded) Newton RR backend forced."""
    n = 512
    a, _ = laplacian_1d(n)
    rows, cols = np.nonzero(a)
    op = shard_operator(SparseOperator.from_coo(rows, cols, a[rows, cols],
                                                a.shape), mesh)
    params = GCGParams(nev=5, block_size=3, verbose=0, rr_backend="newton",
                       tol_rel=1e-8)
    res = gcg_solve(op, None, params, mesh=mesh)
    assert res.nev_conv >= 5
    np.testing.assert_allclose(res.eval[:5], laplacian_1d_eigs(n)[:5],
                               rtol=1e-7)


def test_halo_overlap_edge_corrections(mesh, rng):
    """The overlap-form halo path (interior SpMM against a zero halo +
    separate edge corrections, the PHG dataflow pattern) must be exact for
    an ASYMMETRIC multi-diagonal band crossing several boundary offsets."""
    from gcge_tpu.ops.operators import DiaOperator

    n = 512
    offsets = (-7, -3, -1, 0, 2, 5)
    rng2 = np.random.default_rng(11)
    vals = rng2.standard_normal((len(offsets), n))
    # zero out entries pointing outside the global matrix
    for d, off in enumerate(offsets):
        if off < 0:
            vals[d, :(-off)] = 0.0
        else:
            vals[d, n - off:] = 0.0
    dia = DiaOperator(jnp.asarray(vals), offsets, n)
    x = jnp.asarray(rng.standard_normal((n, 6)))
    y_ref = np.asarray(dia.matvec(x))
    y_d = np.asarray(shard_operator(dia, mesh).matvec(shard_rows(mesh, x)))
    np.testing.assert_allclose(y_d, y_ref, rtol=1e-13, atol=1e-13)


def _irregular_band(n, per_row, band, seed):
    """Random symmetric-free couplings within +-band of the diagonal."""
    import scipy.sparse as sps

    rng2 = np.random.default_rng(seed)
    r = np.repeat(np.arange(n), per_row)
    c = r + rng2.integers(-band, band + 1, size=len(r))
    keep = (c >= 0) & (c < n)
    r, c = r[keep], c[keep]
    v = rng2.standard_normal(len(r))
    return sps.coo_matrix((v, (r, c)), shape=(n, n)).tocsr().tocoo()


@pytest.mark.parametrize("per_row,band,seed", [
    (9, 60, 7),      # band inside the local row block
    (5, 200, 11),    # band wider than the local block
    (3, 511, 3),     # couplings across the whole matrix
])
def test_sharded_ell_irregular_matches_local(mesh, rng, per_row, band, seed):
    """Row-sharded gather-ELL (all-gather + local gather SpMM) on irregular
    patterns against the local ELL operator and the scipy oracle, f64 and
    f32 (reference: distributed CCS SpMM, app_slepc.c:155-216)."""
    n = 512
    a = _irregular_band(n, per_row, band, seed)
    op = SparseOperator.from_coo(a.row, a.col, a.data, (n, n))
    op_d = shard_operator(op, mesh)
    x = rng.standard_normal((n, 5))
    y_local = np.asarray(op.matvec(jnp.asarray(x)))
    y_dist = np.asarray(op_d.matvec(shard_rows(mesh, jnp.asarray(x))))
    np.testing.assert_allclose(y_dist, y_local, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(y_dist, a @ x, rtol=1e-12, atol=1e-12)
    op32 = SparseOperator.from_coo(a.row, a.col, a.data, (n, n),
                                   dtype=jnp.float32)
    y32 = np.asarray(shard_operator(op32, mesh).matvec(
        shard_rows(mesh, jnp.asarray(x, jnp.float32))))
    np.testing.assert_allclose(y32, a @ x, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mixed", [False, True])
def test_distributed_gcg_ell(mesh, mixed):
    """Full distributed GCG over the sharded gather-ELL path, with the plain
    f64 inner CG and with the mixed f32/f64 one."""
    n = 512
    a, h = laplacian_1d(n)
    rows, cols = np.nonzero(a)
    op_d = shard_operator(
        SparseOperator.from_coo(rows, cols, a[rows, cols], a.shape), mesh)
    p = GCGParams(nev=6, block_size=3, max_iter=100, verbose=0,
                  cg_mixed=mixed, cg_refine=2)
    res = gcg_solve(op_d, None, p, mesh=mesh)
    exact = laplacian_1d_eigs(n)[:6]
    assert res.nev_conv >= 6
    np.testing.assert_allclose(res.eval[:6], exact, rtol=1e-7)
