"""Orthogonalization conformance tests.

Asserting re-make of the reference's ``TestOrth``
(``/root/reference/test/test_orth.c:21-177``): random blocks with duplicated
columns must come back B-orthonormal with the numerical rank detected and
dependent columns deflated (here: zeroed and compacted to the back).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gcge_tpu.ops.operators import DenseOperator
from gcge_tpu.solvers.orth import mgs_orth, orth_against, orth_block, orth_block_against


def _spd(n, rng):
    b = rng.standard_normal((n, n))
    return b @ b.T + n * np.eye(n)


def test_orth_block_full_rank(rng):
    x = jnp.asarray(rng.standard_normal((60, 8)))
    q, rank = orth_block(x)
    assert int(rank) == 8
    g = np.asarray(q.T @ q)
    np.testing.assert_allclose(g, np.eye(8), atol=1e-12)


def test_orth_block_rank_deficient(rng):
    """10 vectors, 5 duplicated — rank must drop to 5, zeros at the back."""
    x = rng.standard_normal((60, 5))
    xx = jnp.asarray(np.concatenate([x, x], axis=1))  # rank 5
    q, rank = orth_block(xx)
    assert int(rank) == 5
    qn = np.asarray(q)
    np.testing.assert_allclose(qn[:, 5:], 0.0, atol=1e-10)
    np.testing.assert_allclose(qn[:, :5].T @ qn[:, :5], np.eye(5), atol=1e-11)


def test_orth_block_b_inner(rng):
    n = 50
    b = _spd(n, rng)
    bop = DenseOperator(jnp.asarray(b))
    x = jnp.asarray(rng.standard_normal((n, 6)))
    q, rank = orth_block(x, bop.matvec)
    assert int(rank) == 6
    g = np.asarray(q).T @ b @ np.asarray(q)
    np.testing.assert_allclose(g, np.eye(6), atol=1e-11)


def test_orth_against(rng):
    n = 50
    q, _ = orth_block(jnp.asarray(rng.standard_normal((n, 4))))
    x = jnp.asarray(rng.standard_normal((n, 3)))
    y = orth_against(x, q)
    np.testing.assert_allclose(np.asarray(q.T @ y), 0.0, atol=1e-13)


def test_orth_block_against_combined(rng):
    n = 70
    b = _spd(n, rng)
    bop = DenseOperator(jnp.asarray(b))
    q, _ = orth_block(jnp.asarray(rng.standard_normal((n, 5))), bop.matvec)
    x = jnp.asarray(rng.standard_normal((n, 4)))
    w, rank = orth_block_against(x, q, bop.matvec)
    assert int(rank) == 4
    wn, qn = np.asarray(w), np.asarray(q)
    np.testing.assert_allclose(qn.T @ b @ wn, 0.0, atol=1e-10)
    np.testing.assert_allclose(wn.T @ b @ wn, np.eye(4), atol=1e-10)


def test_orth_against_with_masked_zero_columns(rng):
    """Zero (masked) columns in q must be no-ops — the static-shape contract."""
    n = 40
    q, _ = orth_block(jnp.asarray(rng.standard_normal((n, 3))))
    q_padded = jnp.concatenate([q, jnp.zeros((n, 2))], axis=1)
    x = jnp.asarray(rng.standard_normal((n, 2)))
    np.testing.assert_allclose(
        np.asarray(orth_against(x, q_padded)), np.asarray(orth_against(x, q)), rtol=1e-13
    )


def test_mgs_matches_evp_span(rng):
    """MGS oracle and EVP orth must produce the same orthonormal span."""
    n = 45
    x = jnp.asarray(rng.standard_normal((n, 6)))
    q1, r1 = orth_block(x)
    q2, r2 = mgs_orth(x)
    assert int(r1) == int(r2) == 6
    # same span: projector difference ~ 0
    p1 = np.asarray(q1) @ np.asarray(q1).T
    p2 = np.asarray(q2) @ np.asarray(q2).T
    np.testing.assert_allclose(p1, p2, atol=1e-10)


def test_orth_within_compacts_deflated_columns(rng):
    """bgs/mgs zero dependent columns in place; orth_within must compact
    them to the back so GCG's count-based masks stay valid."""
    import jax.numpy as jnp

    from gcge_tpu.solvers.orth import orth_within

    n, m = 200, 8
    x = rng.standard_normal((n, m))
    x[:, 3] = x[:, 1]          # duplicate -> one column deflates mid-block
    x[:, 6] = 2 * x[:, 0]
    for method in ("evp", "bgs", "mgs"):
        q, rank = orth_within(jnp.asarray(x), method=method, zero_tol=1e-10)
        q, r = np.asarray(q), int(rank)
        assert r == 6, (method, r)
        # first r columns orthonormal, trailing columns exactly zero
        np.testing.assert_allclose(q[:, :r].T @ q[:, :r], np.eye(r),
                                   atol=5e-12, err_msg=method)
        assert np.abs(q[:, r:]).max() == 0.0, method


def test_orth_block_wide_uses_newton_eigh(rng):
    """Wide blocks (>= F32_WARM_MIN_M columns) route the Gram eigh through
    the multi-pass Newton path — the huge-nev InitializeX regime."""
    import jax.numpy as jnp

    from gcge_tpu.solvers.orth import orth_block

    n, m = 1600, 800
    x = rng.standard_normal((n, m))
    x[:, 5] = x[:, 2] + x[:, 3]          # one dependent column
    q, rank = orth_block(jnp.asarray(x), zero_tol=1e-10)
    q, r = np.asarray(q), int(rank)
    assert r == m - 1
    g = q[:, :r].T @ q[:, :r]
    assert np.abs(g - np.eye(r)).max() < 1e-11
    assert np.abs(q[:, r:]).max() == 0.0


def test_orth_block_against_mixed_precision(rng):
    """precision='mixed' (f64 first/trailing passes, f32 middle pass):
    the final cross-leakage and within-block orthonormality must still reach
    the f64 floor — the mixed pass only touches an intermediate
    small-coefficient projection."""
    n, nq, m = 20000, 30, 6
    q, _ = orth_block(jnp.asarray(rng.standard_normal((n, nq))))
    x = rng.standard_normal((n, m))
    # make x nearly dependent on q (the hard case: most of x lies in span(q))
    x[:, :3] = np.asarray(q[:, :3]) + 1e-6 * x[:, :3]
    y, rank = orth_block_against(jnp.asarray(x), q, precision="mixed")
    assert int(rank) == m
    yn, qn = np.asarray(y), np.asarray(q)
    r = int(rank)
    assert np.abs(qn.T @ yn[:, :r]).max() < 1e-12       # cross-leakage
    np.testing.assert_allclose(yn[:, :r].T @ yn[:, :r], np.eye(r), atol=1e-11)
    # and the result must match the f64 path's subspace: the bulk removal
    # (first pass) and the final floor (trailing pass) are f64 in both, so
    # even the nearly-dependent columns' noise-scale remainder directions
    # agree to ~1e-7 * eps_f32-level angles
    y64, _ = orth_block_against(jnp.asarray(x), q, precision="f64")
    s = np.linalg.svd(np.asarray(y64).T @ yn, compute_uv=False)
    np.testing.assert_allclose(s[:r], 1.0, atol=1e-9)
