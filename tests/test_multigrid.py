"""Multigrid tests — the asserting re-make of ``test/test_multi_grid.c``:
build a hierarchy, round-trip a multivector fine->coarse->fine, and solve with
the BAMG V-cycle against a known solution."""

import jax.numpy as jnp
import numpy as np
import pytest

from gcge_tpu.solvers.multigrid import (
    bamg_solve,
    build_hierarchy,
    multivec_from_i_to_j,
)
from tests.conftest import laplacian_1d


@pytest.fixture(scope="module")
def hier():
    a, _ = laplacian_1d(512)
    rows, cols = np.nonzero(a)
    return build_hierarchy(rows, cols, a[rows, cols], 512, max_levels=3), a


def test_hierarchy_shapes(hier):
    h, a = hier
    assert h.num_levels == 3
    sizes = [lv.a_op.shape[0] for lv in h.levels]
    assert sizes[0] == 512 and sizes[0] > sizes[1] > sizes[2]
    # coarse operator stays SPD-ish: positive diagonal
    for lv in h.levels:
        d = np.diag(np.asarray(lv.a_op.to_dense()))
        assert (d > 0).all()


def test_transfer_roundtrip(hier):
    """Fine->coarse->fine must reproduce smooth vectors well (the reference
    prints the round-trip for eyeballing; smooth modes are what P preserves)."""
    h, a = hier
    n = 512
    t = np.linspace(0, 1, n + 2)[1:-1]
    smooth = np.stack([np.sin(np.pi * t), np.sin(2 * np.pi * t)], axis=1)
    x = jnp.asarray(smooth)
    x_c = multivec_from_i_to_j(h, x, 0, 2)
    assert x_c.shape[0] == h.levels[2].a_op.shape[0]
    x_back = multivec_from_i_to_j(h, x_c, 2, 0)
    # projection onto the coarse space: the smooth mode survives (cosine > .9)
    num = np.abs(np.einsum("nm,nm->m", np.asarray(x_back), smooth))
    den = np.linalg.norm(np.asarray(x_back), axis=0) * np.linalg.norm(smooth, axis=0)
    assert (num / den > 0.9).all()


def test_bamg_solves_poisson(hier):
    h, a = hier
    rng = np.random.default_rng(5)
    x_true = rng.standard_normal((512, 3))
    b = jnp.asarray(a @ x_true)
    x, niter, rel = bamg_solve(h, b, max_cycles=30, rtol=1e-9)
    assert float(jnp.max(rel)) < 1e-9
    # error bound: kappa(A) ~ 6.5e4 times the residual tolerance
    np.testing.assert_allclose(np.asarray(x), x_true, rtol=1e-3, atol=1e-4)
    # multigrid must be much faster than the smoother alone would be
    assert niter < 30


def test_bamg_generalized_mass_coarsening():
    a, h_ = laplacian_1d(256)
    rows, cols = np.nonzero(a)
    b_vals = np.where(rows == cols, h_, 0.0)[rows != -1]  # diag mass, same pattern
    hier = build_hierarchy(rows, cols, a[rows, cols], 256,
                           b_vals=b_vals, max_levels=3)
    for lv in hier.levels:
        assert lv.b_op is not None
        bd = np.asarray(lv.b_op.to_dense())
        np.testing.assert_allclose(bd, bd.T, atol=1e-12)
        assert (np.linalg.eigvalsh(bd) > 0).all()


def test_amg_preconditioned_gcg(rng):
    """A single AMG V-cycle as the inner-CG preconditioner (the form of
    the reference's flag=2 'external solver preconditions BPCG' mode) must
    cut GCG iterations on an ill-conditioned operator."""
    import jax.numpy as jnp
    import numpy as np

    from gcge_tpu.ops.operators import make_operator
    from gcge_tpu.solvers.gcg import GCGParams, gcg_solve
    from gcge_tpu.solvers.multigrid import _vcycle, build_hierarchy
    from tests.conftest import laplacian_1d, laplacian_1d_eigs

    n = 2000
    a, h = laplacian_1d(n)
    rows, cols = np.nonzero(a)
    vals = a[rows, cols]
    op = make_operator(rows, cols, vals, a.shape)
    hier = build_hierarchy(rows, cols, vals, n, max_levels=4, min_coarse=50)

    def amg_precond(r):
        return _vcycle(hier, 0, r, jnp.zeros_like(r), (2, 2, 2, 2), 30,
                       1e-16, 1e-30)

    base = GCGParams(nev=5, block_size=3, max_iter=150, verbose=0,
                     cg_max_iter=10)
    plain = gcg_solve(op, None, base)
    pc = gcg_solve(op, None, GCGParams(**{**base.__dict__,
                                          "linear_precond": amg_precond}))
    assert pc.nev_conv >= 5
    np.testing.assert_allclose(pc.eval[:5], laplacian_1d_eigs(n)[:5],
                               rtol=1e-7)
    # preconditioning must make the inverse-power correction far more
    # accurate per iteration: require a real iteration-count win
    assert pc.num_iter < plain.num_iter * 0.7 or plain.nev_conv < 5


def test_chebyshev_smoother_vcycle(hier, rng):
    """Chebyshev-smoothed V-cycles (inner-product-free smoothing) converge
    like the CG-smoothed ones on the Poisson problem."""
    h, a = hier
    n = a.shape[0]
    x_true = rng.standard_normal((n, 3))
    b = jnp.asarray(a @ x_true)
    x, it, rel = bamg_solve(h, b, max_cycles=30, rtol=1e-10,
                            smoother="chebyshev")
    assert float(np.max(np.asarray(rel))) < 1e-10
    np.testing.assert_allclose(np.asarray(x), x_true, rtol=0, atol=1e-7)
    # per-level Chebyshev data was recorded by build_hierarchy
    assert all(lv.dinv is not None and lv.lam_max for lv in h.levels)


def test_bamg_preconditioner_helper(rng):
    """bamg_preconditioner (Chebyshev-smoothed V-cycle closure) plugs into
    GCGParams.linear_precond and converges to the oracle."""
    from gcge_tpu.ops.operators import make_operator
    from gcge_tpu.solvers.gcg import GCGParams, gcg_solve
    from gcge_tpu.solvers.multigrid import bamg_preconditioner, build_hierarchy
    from tests.conftest import laplacian_1d, laplacian_1d_eigs

    n = 1500
    a, _ = laplacian_1d(n)
    rows, cols = np.nonzero(a)
    vals = a[rows, cols]
    op = make_operator(rows, cols, vals, a.shape)
    hier = build_hierarchy(rows, cols, vals, n, max_levels=4, min_coarse=50)
    params = GCGParams(nev=5, block_size=3, max_iter=60, verbose=0,
                       cg_max_iter=10,
                       linear_precond=bamg_preconditioner(hier))
    res = gcg_solve(op, None, params)
    assert res.nev_conv >= 5
    np.testing.assert_allclose(res.eval[:5], laplacian_1d_eigs(n)[:5],
                               rtol=1e-7)
