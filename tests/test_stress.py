"""Randomized stress tests (VERDICT round-2 item 9).

Two classes of bugs the advisor/judge kept finding by hand become
regression-testable here:

1. ``eigh_newton``'s cluster machinery (``ops/eighs.py``) is tuned by magic
   constants (``NEWTON_MIN_M``, re-entrant floors, cluster cap) validated on
   a handful of in-context spectra; a randomized sweep over cluster
   structure x m x cap catches the class of failure ADVICE round 1 found
   (adversarial spectra breaking the closing stage).
2. ``_check_convergence_traced`` / ``_check_convergence_host``
   (``solvers/gcg.py``) are hand-kept twins of nontrivial semantics
   (first-unconverged scan, gapMin multiplicity backoff with the multiMax
   cap, active-window assembly with tail extension + fallback) — the
   reference implements this once (``ops_eig_sol_gcg.c:195-315``), we carry
   two; a property test asserts they agree on random inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gcge_tpu.ops.eighs import eigh_newton
from gcge_tpu.solvers.gcg import (_check_convergence_host,
                                  _check_convergence_traced)


def _random_clustered_spectrum(rng, m):
    """Random spectrum with random cluster widths 1..2m/3 and intra-cluster
    spacings spanning 1e-3..1e-12 of the cluster gap scale."""
    lam = []
    v = float(rng.uniform(0.05, 1.0))
    while len(lam) < m:
        width = int(rng.integers(1, max(2 * m // 3, 2)))
        spacing = 10.0 ** rng.uniform(-12, -3)
        lam += [v + spacing * i for i in range(width)]
        v += float(rng.uniform(0.2, 2.0))
    return np.sort(np.asarray(lam[:m]))


@pytest.mark.parametrize("seed,m,cap", [
    (0, 128, 32), (1, 128, 512),
    (2, 320, 64), (3, 320, 32),
    (4, 768, 64), (5, 768, 512),
])
def test_eigh_newton_random_clusters(seed, m, cap):
    """Random cluster structures x m x cap, with an f32-grade corrupted warm
    start: eigen-residual and orthonormality must hit f64 floors."""
    rng = np.random.default_rng(seed)
    lam = _random_clustered_spectrum(rng, m)
    q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    h = q @ np.diag(lam) @ q.T
    h = 0.5 * (h + h.T)
    # corrupted warm start carrying an f32-level backtransform error
    w_ex, u_ex = np.linalg.eigh(h)
    noise = 3e-6 * rng.standard_normal((m, m))
    u0 = u_ex @ np.linalg.qr(np.eye(m) + 0.5 * (noise - noise.T))[0]
    w, u = eigh_newton(jnp.asarray(h), cap=cap,
                       warm=(jnp.asarray(w_ex), jnp.asarray(u0)))
    w, u = np.asarray(w), np.asarray(u)
    scale = np.abs(lam).max()
    assert np.abs(h @ u - u * w[None, :]).max() < 5e-11 * scale
    assert np.abs(u.T @ u - np.eye(m)).max() < 5e-11
    assert np.abs(np.sort(w) - lam).max() < 5e-11 * scale


def _random_conv_case(rng):
    size_x = int(rng.integers(20, 120))
    bs = int(rng.integers(2, 12))
    cw = int(rng.integers(bs, 2 * bs + 1))
    cw = min(cw, size_x)
    m = size_x + 2 * bs
    # clustered ascending eigenvalues so gapMin actually fires
    lam = np.cumsum(np.where(rng.random(m) < 0.4,
                             10.0 ** rng.uniform(-12, -4, m),
                             rng.uniform(0.05, 1.0, m))) + 0.1
    c0 = int(rng.integers(0, size_x - cw + 1))
    scan_from = int(rng.integers(0, min(3, cw)))
    nev_conv_prev = c0 + scan_from
    res = 10.0 ** rng.uniform(-12, 0, cw)
    tol_abs = 10.0 ** rng.uniform(-2, 1)
    tol_rel = 10.0 ** rng.uniform(-9, -5)
    gap_min = 10.0 ** rng.uniform(-4, -1)
    multi_max = int(rng.integers(1, bs + 1))
    return (res, lam, c0, scan_from, nev_conv_prev, size_x, bs,
            tol_abs, tol_rel, gap_min, multi_max)


@pytest.mark.parametrize("seed", range(40))
def test_check_convergence_traced_matches_host(seed):
    rng = np.random.default_rng(1000 + seed)
    (res, lam, c0, scan_from, nev_conv_prev, size_x, bs, tol_abs, tol_rel,
     gap_min, multi_max) = _random_conv_case(rng)
    nev_h, act_h, cnt_h = _check_convergence_host(
        res, lam, c0, scan_from, nev_conv_prev, size_x, bs,
        tol_abs, tol_rel, gap_min, multi_max)
    nev_t, act_t, cnt_t = _check_convergence_traced(
        jnp.asarray(res), jnp.asarray(lam), jnp.int32(c0),
        jnp.int32(scan_from), jnp.int32(nev_conv_prev), size_x, bs,
        tol_abs, tol_rel, gap_min, jnp.int32(multi_max))
    assert int(nev_t) == int(nev_h), (seed, nev_conv_prev, c0, scan_from)
    assert int(cnt_t) == int(cnt_h)
    np.testing.assert_array_equal(np.asarray(act_t)[:int(cnt_h)],
                                  np.asarray(act_h)[:int(cnt_h)])


def test_struct_warm_gate_matches_cold_eigh():
    """Regression (round 4): the structural RR warm start silently corrupted
    the basis when its residual-sized-coupling premise failed (early
    iterations) — nev=200/bs=80 stalled at nev_conv=0 with lam0 BELOW the
    true minimum.  With the coupling gate, struct must match the cold
    Newton path exactly on a config that previously broke."""
    import scipy.sparse as sps

    from gcge_tpu.ops.operators import make_operator
    from gcge_tpu.solvers.gcg import GCGParams, gcg_solve

    n1 = 14
    I = sps.identity(n1)
    T = sps.diags([-np.ones(n1 - 1), 2 * np.ones(n1), -np.ones(n1 - 1)],
                  [-1, 0, 1])
    A3 = (sps.kron(sps.kron(I, I), T) + sps.kron(sps.kron(I, T), I)
          + sps.kron(sps.kron(T, I), I)).tocoo()
    n = A3.shape[0]
    op = make_operator(A3.row, A3.col, A3.data, (n, n))
    res = {}
    for warm in ("struct", "off"):
        p = GCGParams(nev=60, block_size=24, max_iter=80, verbose=0, fuse=0,
                      cg_max_iter=30, cg_auto_shift=True,
                      rr_backend="newton", rr_warm=warm)
        res[warm] = gcg_solve(op, None, p)
    assert res["struct"].nev_conv >= 60
    assert res["off"].nev_conv >= 60
    np.testing.assert_allclose(res["struct"].eval[:60], res["off"].eval[:60],
                               rtol=1e-9)
