"""End-to-end GCG eigensolver tests.

The asserting re-make of ``TestEigenSolverGCG``
(``/root/reference/test/test_eig_sol_gcg.c``) on the reference's model
problems: 1D Laplacian with the analytic spectrum as oracle
(``test_app_lapack.c:41-69`` / ``test_app_ccs.c:142-184``), standard and
generalized (B = diag mass) variants, dense and sparse backends.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gcge_tpu.ops.operators import DenseOperator, DiagOperator, SparseOperator
from gcge_tpu.solvers.gcg import GCGParams, gcg_solve
from tests.conftest import laplacian_1d, laplacian_1d_eigs


def _check_eigs(result, a, b, nev, tol_rel=1e-8, exact=None):
    lam = result.eval[:nev]
    x = np.asarray(result.evec)[:, :nev]
    bmat = b if b is not None else np.eye(a.shape[0])
    res = a @ x - (bmat @ x) * lam[None, :]
    rel = np.linalg.norm(res, axis=0) / np.abs(lam)
    assert result.nev_conv >= nev, f"only {result.nev_conv} converged"
    assert (rel < tol_rel * 50).all(), f"residuals {rel}"
    if exact is not None:
        np.testing.assert_allclose(lam, exact[:nev], rtol=1e-7)


def test_gcg_dense_laplacian_standard():
    n, nev = 400, 10
    a, _ = laplacian_1d(n)
    exact = laplacian_1d_eigs(n)
    params = GCGParams(nev=nev, max_iter=60, verbose=0, cg_max_iter=30)
    result = gcg_solve(DenseOperator(jnp.asarray(a)), None, params)
    _check_eigs(result, a, None, nev, exact=exact)


def test_gcg_sparse_laplacian_standard():
    n, nev = 500, 12
    a, _ = laplacian_1d(n)
    rows, cols = np.nonzero(a)
    sp = SparseOperator.from_coo(rows, cols, a[rows, cols], a.shape)
    exact = laplacian_1d_eigs(n)
    params = GCGParams(nev=nev, max_iter=60, verbose=0, cg_max_iter=30)
    result = gcg_solve(sp, None, params)
    _check_eigs(result, a, None, nev, exact=exact)


def test_gcg_generalized_diag_mass():
    """A x = lambda B x with B = h*I (the reference CCS driver's mass,
    ``test_app_ccs.c:142-184``): spectrum scales by 1/h."""
    n, nev = 300, 8
    a, h = laplacian_1d(n)
    bdiag = np.full(n, h)
    exact = laplacian_1d_eigs(n) / h
    params = GCGParams(nev=nev, max_iter=60, verbose=0, cg_max_iter=40)
    result = gcg_solve(
        DenseOperator(jnp.asarray(a)), DiagOperator(jnp.asarray(bdiag)), params
    )
    _check_eigs(result, a, np.diag(bdiag), nev, exact=exact)


def test_gcg_generalized_dense_mass(rng):
    """Full SPD mass matrix."""
    n, nev = 200, 6
    a, _ = laplacian_1d(n)
    import scipy.linalg

    c = rng.standard_normal((n, n)) * 0.01
    b = np.eye(n) + c @ c.T
    exact = scipy.linalg.eigh(a, b, eigvals_only=True)
    params = GCGParams(nev=nev, max_iter=80, verbose=0, cg_max_iter=40)
    result = gcg_solve(
        DenseOperator(jnp.asarray(a)), DenseOperator(jnp.asarray(b)), params
    )
    _check_eigs(result, a, b, nev, exact=exact)


def test_gcg_auto_shift():
    """compW_cg_auto_shift accelerates the inner solve; result unchanged."""
    n, nev = 300, 8
    a, _ = laplacian_1d(n)
    exact = laplacian_1d_eigs(n)
    params = GCGParams(nev=nev, block_size=3, max_iter=100, verbose=0,
                       cg_auto_shift=True)
    result = gcg_solve(DenseOperator(jnp.asarray(a)), None, params)
    _check_eigs(result, a, None, nev, exact=exact)


def test_gcg_warm_start():
    """nevGiven > 0: exact eigenvectors as initial guess -> fast convergence
    (reference ``InitializeX`` keeps and orthonormalizes given vectors)."""
    n, nev = 200, 6
    a, _ = laplacian_1d(n)
    w, v = np.linalg.eigh(a)
    x0 = jnp.asarray(v[:, :nev] + 1e-6 * np.random.default_rng(1).standard_normal((n, nev)))
    params = GCGParams(nev=nev, block_size=3, max_iter=30, verbose=0)
    result = gcg_solve(DenseOperator(jnp.asarray(a)), None, params, x0=x0)
    _check_eigs(result, a, None, nev, exact=w)
    # nevConv advances at most bs per check window (as in the reference),
    # so a warm start still needs ~nev/bs checks plus a few refinements.
    assert result.num_iter <= 12


def test_gcg_restart_growth():
    """nev_init < nev_max exercises the restart/size-growth path
    (``ops_eig_sol_gcg.c:1400-1428``)."""
    n, nev = 300, 10
    a, _ = laplacian_1d(n)
    exact = laplacian_1d_eigs(n)
    params = GCGParams(
        nev=nev, block_size=4, nev_max=20, nev_init=12, max_iter=100, verbose=0
    )
    result = gcg_solve(DenseOperator(jnp.asarray(a)), None, params)
    _check_eigs(result, a, None, nev, exact=exact)


def test_gcg_clustered_spectrum():
    """Multiplicity handling (gapMin backoff): operator with repeated
    eigenvalues must still converge with correct multiplicity.  As in the
    reference (``assert multiMax <= block_size``,
    ``ops_eig_sol_gcg.c:1280``), the block size must cover the largest
    multiplicity — here 3."""
    n, nev = 128, 8
    rng = np.random.default_rng(7)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.concatenate([np.repeat([1.0, 2.0, 3.0], 3), np.arange(4.0, 4.0 + n - 9)])
    a = (q * lam) @ q.T
    a = 0.5 * (a + a.T)
    params = GCGParams(nev=nev, block_size=4, max_iter=100, verbose=0, cg_max_iter=50)
    result = gcg_solve(DenseOperator(jnp.asarray(a)), None, params)
    _check_eigs(result, a, None, nev, exact=np.sort(lam))


def test_gcg_cg_order2():
    """ComputeW12 variant (compW_cg_order=2, ``ops_eig_sol_gcg.c:697-923``):
    half-width active window with two Krylov stages per column."""
    n, nev = 300, 8
    a, _ = laplacian_1d(n)
    exact = laplacian_1d_eigs(n)
    params = GCGParams(nev=nev, block_size=4, max_iter=80, verbose=0,
                       cg_order=2, cg_max_iter=20)
    result = gcg_solve(DenseOperator(jnp.asarray(a)), None, params)
    _check_eigs(result, a, None, nev, exact=exact)


def test_gcg_user_linear_solver():
    """user_defined_multi_linear_solver hook: plug a custom inner solve."""
    from gcge_tpu.solvers.bpcg import BlockPCGParams, block_pcg

    def my_solver(matvec, rhs, x0, active):
        x, _ = block_pcg(matvec, rhs, x0,
                         BlockPCGParams(max_iter=40, rate=1e-3, tol=1e-14),
                         active0=active)
        return x

    n, nev = 300, 6
    a, _ = laplacian_1d(n)
    exact = laplacian_1d_eigs(n)
    params = GCGParams(nev=nev, block_size=3, max_iter=80, verbose=0,
                       linear_solver=my_solver)
    result = gcg_solve(DenseOperator(jnp.asarray(a)), None, params)
    _check_eigs(result, a, None, nev, exact=exact)


def test_gcg_fused_matches_phasewise():
    """fuse>0 runs whole iterations as one device dispatch (traced
    convergence/window logic) — must match the phase-wise path."""
    n, nev = 300, 8
    a, _ = laplacian_1d(n)
    exact = laplacian_1d_eigs(n)
    op = DenseOperator(jnp.asarray(a))
    r0 = gcg_solve(op, None, GCGParams(nev=nev, max_iter=80, verbose=0, fuse=0))
    r8 = gcg_solve(op, None, GCGParams(nev=nev, max_iter=80, verbose=0, fuse=8))
    assert r8.nev_conv >= nev
    np.testing.assert_allclose(r8.eval[:nev], exact[:nev], rtol=1e-7)
    np.testing.assert_allclose(r8.eval[:nev], r0.eval[:nev], rtol=1e-9)
    # fused restart-growth path
    rg = gcg_solve(op, None, GCGParams(nev=nev, block_size=3, nev_max=16,
                                       nev_init=9, max_iter=100, verbose=0,
                                       fuse=4))
    assert rg.nev_conv >= nev
    np.testing.assert_allclose(rg.eval[:nev], exact[:nev], rtol=1e-7)


def test_gcg_host_eigh_backend():
    """rr_backend='host' routes the projected eigh through pure_callback to
    LAPACK — results must match the device path."""
    n, nev = 300, 8
    a, _ = laplacian_1d(n)
    exact = laplacian_1d_eigs(n)
    op = DenseOperator(jnp.asarray(a))
    r = gcg_solve(op, None, GCGParams(nev=nev, max_iter=80, verbose=0,
                                      rr_backend="host", fuse=4))
    assert r.nev_conv >= nev
    np.testing.assert_allclose(r.eval[:nev], exact[:nev], rtol=1e-7)


def test_gcg_mixed_precision_cg():
    """cg_mixed: f32 transposed-CG stages + f64 refinement must still reach
    the f64 convergence tolerance (DIA operator required)."""
    from gcge_tpu.ops.operators import DiaOperator

    n, nev = 400, 8
    a, _ = laplacian_1d(n)
    rows, cols = np.nonzero(a)
    dia = DiaOperator.from_coo(rows, cols, a[rows, cols], a.shape)
    exact = laplacian_1d_eigs(n)
    params = GCGParams(nev=nev, block_size=4, max_iter=100, verbose=0,
                       cg_mixed=True, cg_refine=2, fuse=4)
    result = gcg_solve(dia, None, params)
    _check_eigs(result, a, None, nev, exact=exact)


def test_cross_validate_vs_scipy_lobpcg(rng):
    """Cross-validation against an independent eigensolver (the reference
    cross-checks against SLEPc's EPS family, test_app_slepc.c:592+; here
    scipy's LOBPCG plays that role)."""
    import numpy as np
    import scipy.sparse as sps
    from scipy.sparse.linalg import lobpcg

    from gcge_tpu import GCGParams, gcg_solve, make_operator
    from tests.conftest import laplacian_1d

    n = 500
    a, h = laplacian_1d(n)
    rows, cols = np.nonzero(a)
    op = make_operator(rows, cols, a[rows, cols], a.shape)
    res = gcg_solve(op, None, GCGParams(nev=8, block_size=4, max_iter=100,
                                        verbose=0))
    a_s = sps.coo_matrix((a[rows, cols], (rows, cols)), shape=a.shape).tocsr()
    x0 = rng.standard_normal((n, 8))
    w, _ = lobpcg(a_s, x0, largest=False, tol=1e-10, maxiter=500)
    assert res.nev_conv >= 8
    np.testing.assert_allclose(res.eval[:8], np.sort(w)[:8], rtol=1e-8)


def test_gcg_orth_method_variants():
    """GCG converges identically under the EVP / BGS orthogonalizers and
    accepts the reference's -gcge_*_orth_method flag values (ops_orth.h)."""
    from gcge_tpu.ops.operators import make_operator
    from gcge_tpu.utils.cli import params_from_args
    from tests.conftest import laplacian_1d, laplacian_1d_eigs

    n = 600
    a, _ = laplacian_1d(n)
    rows, cols = np.nonzero(a)
    op = make_operator(rows, cols, a[rows, cols], a.shape)
    exact = laplacian_1d_eigs(n)[:5]
    for method in ("evp", "bgs"):
        p = GCGParams(nev=5, block_size=3, verbose=0, orth_method=method)
        res = gcg_solve(op, None, p)
        assert res.nev_conv >= 5, method
        np.testing.assert_allclose(res.eval[:5], exact, rtol=1e-8,
                                   err_msg=method)
    p, _ = params_from_args(["-gcge_compW_orth_method", "bgs"])
    assert p.orth_method == "bgs"
    p, _ = params_from_args(["-gcge_compW_orth_method", "mgs"])
    assert p.orth_method == "mgs"


def test_gcg_matrix_free_operator():
    """Matrix-free A (FunctionOperator): the 1D Laplacian applied as shifts,
    never materialized — the OPS-vtable custom-matvec analogue."""
    import jax.numpy as jnp

    from gcge_tpu.ops.operators import FunctionOperator
    from tests.conftest import laplacian_1d_eigs

    n = 500
    h = 1.0 / (n + 1)

    def lap(x):
        up = jnp.concatenate([x[1:], jnp.zeros((1, x.shape[1]), x.dtype)])
        dn = jnp.concatenate([jnp.zeros((1, x.shape[1]), x.dtype), x[:-1]])
        return (2.0 * x - up - dn) / h

    op = FunctionOperator(lap, n)
    res = gcg_solve(op, None, GCGParams(nev=5, block_size=3, verbose=0))
    assert res.nev_conv >= 5
    np.testing.assert_allclose(res.eval[:5], laplacian_1d_eigs(n)[:5] / 1.0,
                               rtol=1e-8)


def test_gcg_long_run_basis_stability():
    """Regression: over many iterations at large sizeX, the final
    within-block recombination in orth_block_against amplified residual
    span([X|P]) leakage of near-deflated W columns by 1/sqrt(w_min) —
    basis orthonormality decayed to ~1e-7 and spurious eigenvalues below
    lambda_min appeared (observed on the 1D Laplacian at n=4000, nev=300:
    eval[0] ~ 1e-8 instead of 2.5e-3).  The trailing projection pass must
    keep the smallest Ritz value exact."""
    import scipy.sparse as sps

    from gcge_tpu.ops.operators import make_operator

    n = 4000
    h = 1.0 / (n + 1)
    a = sps.diags([np.full(n - 1, -1 / h), np.full(n, 2 / h),
                   np.full(n - 1, -1 / h)], [-1, 0, 1]).tocoo()
    op = make_operator(a.row, a.col, a.data, (n, n))
    res = gcg_solve(op, None, GCGParams(nev=300, block_size=60, verbose=0,
                                        tol_rel=1e-7, max_iter=40))
    k = np.arange(1, 301)
    exact = (2.0 / h) * (1.0 - np.cos(k * np.pi * h))
    # nev_conv stalls at ~200 by gap_min design (relative gaps < 1e-2 past
    # k~200 on the 1D spectrum); what must NOT happen is eigenvalue
    # corruption:
    assert res.eval[0] > 2e-3
    assert np.abs(res.eval[:200] - exact[:200]).max() < 1e-9 * exact.max()


def test_multi_max_caps_backoff():
    """The gapMin backoff never walks back more than multi_max positions
    (the reference's multiMax, asserted <= block_size at
    ``ops_eig_sol_gcg.c:1280``; CLI ``-gcge_max_multi`` ``:1743``)."""
    from gcge_tpu.solvers.gcg import (_check_convergence_host,
                                      _check_convergence_traced)
    import jax.numpy as jnp

    cw, bs, size_x = 8, 4, 40
    # eigenvalues with ALL relative gaps below gap_min=0.01 -> uncapped
    # backoff walks to 0
    ss_eval = 1.0 + 0.001 * np.arange(size_x + 2 * bs)
    res = np.full(cw, 1e-12)
    res[5] = 1.0                     # first unconverged at window index 5
    nc_uncap, _, _ = _check_convergence_host(
        res, ss_eval, 0, 0, 0, size_x, bs, 1e-1, 1e-8, 0.01, None)
    assert nc_uncap == 0             # full backoff: cluster swallows all
    nc_cap, _, _ = _check_convergence_host(
        res, ss_eval, 0, 0, 0, size_x, bs, 1e-1, 1e-8, 0.01, 2)
    assert nc_cap == 3               # backed off exactly multi_max=2 from 5
    # traced twin agrees
    nc_t, _, _ = _check_convergence_traced(
        jnp.asarray(res), jnp.asarray(ss_eval), jnp.int32(0), jnp.int32(0),
        jnp.int32(0), size_x, bs, 1e-1, 1e-8, 0.01, 2)
    assert int(nc_t) == 3


def test_multi_max_e2e_clustered_spectrum():
    """E2E regression on an artificially clustered spectrum: every relative
    gap is below gap_min, so the uncapped backoff would hold nevConv at 0
    until the whole window converged; with multi_max the count advances
    early and the solve still returns the right eigenvalues."""
    n, nev = 300, 4
    lam = 1.0 + 0.001 * np.arange(n)        # all relative gaps ~1e-3 < 0.01
    a = np.diag(lam)
    rng = np.random.default_rng(7)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = q @ a @ q.T
    a = 0.5 * (a + a.T)
    params = GCGParams(nev=nev, block_size=3, multi_max=1, max_iter=120,
                       verbose=0, cg_max_iter=30, tol_rel=1e-7)
    result = gcg_solve(DenseOperator(jnp.asarray(a)), None, params)
    assert result.nev_conv >= nev
    np.testing.assert_allclose(np.sort(result.eval[:nev]), lam[:nev],
                               rtol=1e-6)
    # the capped backoff must have advanced nevConv before full convergence
    partial = [c for (_, c) in result.history if 0 < c < nev]
    assert partial, "nevConv never advanced partially - cap ineffective?"


def test_fuse_hotswap_mid_solve(monkeypatch):
    """Hot-swap cold start: with the fused chunk compiling in a background
    thread (delayed via the test hook), the solve starts phased, swaps to
    the fused loop when the compile lands, and still converges to the
    analytic spectrum; the compiled executable is memoized so the next
    solve starts fused immediately."""
    import time as _time

    from gcge_tpu.ops.operators import make_operator
    from gcge_tpu.solvers import gcg as G

    monkeypatch.setenv("GCGE_HOTSWAP_TEST_DELAY", "1.0")
    n = 3000
    a, _ = laplacian_1d(n)
    rows, cols = np.nonzero(a)
    op = make_operator(rows, cols, a[rows, cols], a.shape)
    kw = dict(nev=6, block_size=3, max_iter=400, verbose=0, tol_rel=1e-8)
    n_ready0 = len(G._CHUNK_READY)
    res = gcg_solve(op, None, GCGParams(**kw, fuse=5, fuse_hotswap="on"))
    assert res.nev_conv >= 6
    np.testing.assert_allclose(res.eval[:6], laplacian_1d_eigs(n)[:6],
                               rtol=1e-7)
    # the background compile published its signature + executable (wait for
    # the thread if the solve finished phased before the delay elapsed —
    # generous budget: a loaded CI host can stretch the small compile well
    # past the 1 s test delay)
    for _ in range(600):
        if len(G._CHUNK_READY) > n_ready0:
            break
        _time.sleep(0.1)
    assert len(G._CHUNK_READY) > n_ready0
    assert len(G._HOT_COMPILED) >= 1
    # steady call: goes straight fused via the memoized executable
    monkeypatch.setenv("GCGE_HOTSWAP_TEST_DELAY", "60")  # would stall if used
    t0 = _time.perf_counter()
    res2 = gcg_solve(op, None, GCGParams(**kw, fuse=5, fuse_hotswap="on"))
    steady_wall = _time.perf_counter() - t0
    assert res2.nev_conv >= 6
    assert steady_wall < 30  # no 60 s delay: the hot path was skipped
    np.testing.assert_allclose(res2.eval[:6], laplacian_1d_eigs(n)[:6],
                               rtol=1e-7)
    # hotswap off: the direct fused path is untouched
    res3 = gcg_solve(op, None, GCGParams(**kw, fuse=5, fuse_hotswap="off"))
    assert res3.nev_conv >= 6
    np.testing.assert_allclose(res3.eval[:6], laplacian_1d_eigs(n)[:6],
                               rtol=1e-7)
