"""Eigensolver tests (ops.eighs).

The Jacobi-polished eigh is covered through GCG's end-to-end tests; this file
targets the large-m Newton-refinement path (huge-nev Rayleigh-Ritz,
reference sweeps nev up to 5000 -> projected matrices ~10k,
reference ``test/submit.sh:30-32``).  On CPU the device eigh is exact,
so the refinement machinery is exercised with an explicitly *corrupted* warm
start carrying an f32-level eigenvector backtransform error.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gcge_tpu.ops.eighs import eigh, eigh_jacobi, eigh_newton, safe_eigh


def _clustered_sym(rng, m, clusters):
    """Symmetric matrix with prescribed multiplicities."""
    lam = []
    v = 0.1
    for mult, gap in clusters:
        lam += [v + 1e-10 * i for i in range(mult)]
        v += gap
    if len(lam) < m:
        lam += list(np.linspace(v, v + 10.0, m - len(lam)))
    lam = np.sort(np.asarray(lam[:m]))
    q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    h = q @ np.diag(lam) @ q.T
    return 0.5 * (h + h.T), lam


@pytest.mark.parametrize("m,clusters", [
    (64, [(1, 1.0)] * 10),
    (150, [(6, 0.5), (3, 0.2), (1, 1.0)] * 8),
    (200, [(80, 2.0), (1, 0.3)]),       # cluster wider than the 64 cap
])
def test_eigh_newton_exact_host(rng, m, clusters):
    h, lam = _clustered_sym(rng, m, clusters)
    w, u = eigh_newton(jnp.asarray(h))
    w, u = np.asarray(w), np.asarray(u)
    scale = np.abs(lam).max()
    assert np.abs(h @ u - u * w[None, :]).max() < 1e-12 * scale
    assert np.abs(u.T @ u - np.eye(m)).max() < 1e-12
    assert np.abs(w - lam).max() < 1e-12 * scale


def test_eigh_newton_corrupted_warm_start(rng):
    """Warm-start eigenvectors carrying ~1e-6 backtransform error (an
    f32-accurate device eigh) must be refined to ~1e-12 residuals."""
    m = 180
    h, lam = _clustered_sym(rng, m, [(5, 0.4), (2, 0.1), (1, 0.8)] * 8)
    w_ex, u_ex = np.linalg.eigh(h)
    noise = 3e-6 * rng.standard_normal((m, m))
    u0 = u_ex @ np.linalg.qr(np.eye(m) + 0.5 * (noise - noise.T))[0]
    warm = (jnp.asarray(w_ex), jnp.asarray(u0))
    scale = np.abs(lam).max()
    r0 = np.abs(h @ u0 - u0 * w_ex[None, :]).max()
    assert r0 > 1e-7 * scale          # the warm start really is corrupted
    w, u = eigh_newton(jnp.asarray(h), warm=warm)
    w, u = np.asarray(w), np.asarray(u)
    assert np.abs(h @ u - u * w[None, :]).max() < 1e-11 * scale
    assert np.abs(u.T @ u - np.eye(m)).max() < 1e-11
    assert np.abs(w - lam).max() < 1e-10 * scale


def test_eigh_newton_coarse_warm_giant_clusters(rng):
    """Regression: a COARSE (f32-device-eigh-level) warm start on a tightly
    spaced spectrum makes gap_tol exceed the eigenvalue spacing, gluing the
    whole spectrum into cap-split giant clusters.  The masked Newton stage is
    then a REPELLER — each step amplifies the masked coupling by
    ~cluster_len/8 through second-order cross terms with the intra-cluster
    coupling it cannot touch — and before the trust cap + divergence guard +
    cluster-first ordering this configuration diverged to ~1e49 (a warm
    start with ~4e-5-relative coupling, 50x coarser than LAPACK's f32).
    This reproduces that exact regime host-side: 220 eigenvalues spaced ~1.3e-2 + a 20-fold degenerate
    pad block, warm start rotated by a 6e-4 random skew so the entry coupling
    (~1.8e-2) puts gap_tol (~0.14) far above the spacing."""
    m, mp = 240, 20
    lam = np.concatenate([np.linspace(23.6, 26.5, m - mp), np.full(mp, 32.98)])
    q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    h = q @ np.diag(lam) @ q.T
    h = 0.5 * (h + h.T)
    w_ex, u_ex = np.linalg.eigh(h)
    skew = 6e-4 * rng.standard_normal((m, m))
    skew = 0.5 * (skew - skew.T)
    u0 = u_ex @ np.linalg.qr(np.eye(m) + skew)[0]
    h1 = u0.T @ h @ u0
    off0 = np.abs(h1 - np.diag(np.diag(h1))).max()
    spacing = (26.5 - 23.6) / (m - mp)
    assert 8.0 * off0 > spacing       # the repeller regime really is armed
    w, u = eigh_newton(jnp.asarray(h), warm=(jnp.asarray(w_ex),
                                             jnp.asarray(u0)), passes=3)
    w, u = np.asarray(w), np.asarray(u)
    scale = np.abs(lam).max()
    assert np.abs(h @ u - u * w[None, :]).max() < 1e-11 * scale
    assert np.abs(u.T @ u - np.eye(m)).max() < 1e-11
    assert np.abs(w - lam).max() < 1e-11 * scale


def test_eigh_newton_overcap_near_degenerate(rng):
    """Regression: a near-degenerate run WIDER than the cluster cap (100
    eigenvalues spaced 1e-6 at cap=64), with the warm start fully mixed
    inside the run.  The cap-split batched eighs cannot remove the coupling
    across the split boundaries and refine skips those pairs too
    (gap < gap_tol), so before the over-cap fix-up this plateaued at the
    cluster-width scale (measured 1.2e-5 eigenvalue error / 2e-4 residual).
    Staggered and tournament block-Jacobi sweeps do NOT close it (each
    degenerate block eigh is an arbitrary basis re-scramble; simulated
    stall at ~0.5x entry coupling after 24 sweeps) — only the escalated
    c=min(512, m) single-block rotation does."""
    m, nc = 160, 100
    lam = np.sort(np.concatenate(
        [1.0 + 1e-6 * np.arange(nc), np.linspace(2.0, 50.0, m - nc)]))
    q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    h = (q * lam) @ q.T
    h = 0.5 * (h + h.T)
    u0 = q.copy()
    rc, _ = np.linalg.qr(rng.standard_normal((nc, nc)))
    u0[:, :nc] = u0[:, :nc] @ rc          # fully mix the run's subspace
    skew = 1e-5 * rng.standard_normal((m, m))
    u0 = u0 @ np.linalg.qr(np.eye(m) + skew - skew.T)[0]
    w0 = np.sort(np.diag(u0.T @ h @ u0))
    w, u = eigh_newton(jnp.asarray(h), warm=(jnp.asarray(w0),
                                             jnp.asarray(u0)))
    w, u = np.asarray(w), np.asarray(u)
    scale = np.abs(lam).max()
    assert np.abs(h @ u - u * w[None, :]).max() < 1e-12 * scale
    assert np.abs(u.T @ u - np.eye(m)).max() < 1e-12
    assert np.abs(np.sort(w) - lam).max() < 1e-12 * scale


def test_eigh_newton_identityish(rng):
    """Fully degenerate spectrum: every slot is one cluster."""
    m = 96
    h = 3.0 * np.eye(m)
    w, u = eigh_newton(jnp.asarray(h))
    assert np.abs(np.asarray(w) - 3.0).max() < 1e-12
    u = np.asarray(u)
    assert np.abs(u.T @ u - np.eye(m)).max() < 1e-11


def test_eigh_backend_dispatch(rng):
    h, lam = _clustered_sym(rng, 40, [(1, 1.0)] * 10)
    hd = jnp.asarray(h)
    for backend in ("auto", "device", "jacobi", "newton"):
        w, u = eigh(hd, backend)
        assert np.abs(np.asarray(w) - lam).max() < 1e-10


def test_safe_eigh_matches_numpy(rng):
    h, lam = _clustered_sym(rng, 30, [(2, 0.5)] * 6)
    w, _ = safe_eigh(jnp.asarray(h))
    assert np.abs(np.asarray(w) - lam).max() < 1e-10


# ---------------------------------------------------------------------------
# soak: adversarial spectra (ROADMAP robustness item)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spectrum", [
    "wide",        # 12 decades of dynamic range
    "tiny-noise",  # near-rank-deficient Gram-like: 1e-13..2
    "negative",    # indefinite, clustered at both ends
    "scaled-up",   # large magnitudes (overflow-edge guard in the rotations)
])
def test_eigh_soak_adversarial(rng, spectrum):
    m = 80
    if spectrum == "wide":
        lam = np.logspace(-6, 6, m)
    elif spectrum == "tiny-noise":
        lam = np.concatenate([np.full(6, 1e-13), np.linspace(0.5, 2.0, m - 6)])
    elif spectrum == "negative":
        lam = np.concatenate([np.full(5, -3.0), np.linspace(-1, 1, m - 10),
                              np.full(5, 3.0)])
    else:
        lam = np.linspace(1e8, 5e8, m)
    lam = np.sort(lam)
    q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    h = q @ np.diag(lam) @ q.T
    h = 0.5 * (h + h.T)
    scale = np.abs(lam).max()
    for fn in (safe_eigh, eigh_jacobi, eigh_newton):
        w, u = fn(jnp.asarray(h))
        w, u = np.asarray(w), np.asarray(u)
        assert np.isfinite(w).all() and np.isfinite(u).all(), fn.__name__
        assert np.abs(h @ u - u * w[None, :]).max() < 1e-10 * scale, fn.__name__
        assert np.abs(u.T @ u - np.eye(m)).max() < 1e-10, fn.__name__
        # eigenvalues correct to the shift-retry floor (safe_eigh's base
        # Tikhonov shift is 1e-10*scale)
        assert np.abs(w - lam).max() < 1e-8 * scale, fn.__name__


def test_eigh_newton_dense_spectrum_corrupted(rng):
    """Regression: a GCG-like projected spectrum (hundreds of eigenvalues
    with spacings ~1e-5 of scale) chained into >cap clusters under the old
    fixed theta=1e-4 and plateaued at warm-start accuracy (observed as a
    1e-7 residual floor at nev=200).  The adaptive gap_tol = 8*off0 must
    refine it fully."""
    m = 400
    lam = np.sort(0.004 + 0.45 * (np.arange(m) / m) ** 1.5) * 52.0
    # typical spacing ~1e-4..1e-3 absolute = 2e-6..2e-5 of scale (52)
    q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    h = q @ np.diag(lam) @ q.T
    h = 0.5 * (h + h.T)
    w_ex, u_ex = np.linalg.eigh(h)
    noise = 6e-7 * rng.standard_normal((m, m))
    u0 = u_ex @ np.linalg.qr(np.eye(m) + 0.5 * (noise - noise.T))[0]
    scale = np.abs(lam).max()
    r0 = np.abs(h @ u0 - u0 * w_ex[None, :]).max()
    assert r0 > 1e-6          # corrupted warm start (abs, scale=52)
    w, u = eigh_newton(jnp.asarray(h), warm=(jnp.asarray(w_ex),
                                             jnp.asarray(u0)))
    w, u = np.asarray(w), np.asarray(u)
    assert np.abs(h @ u - u * w[None, :]).max() < 1e-11 * scale
    assert np.abs(w - lam).max() < 1e-11 * scale


def test_rr_struct_warm_matches_lapack(rng):
    """GCG's structural Rayleigh-Ritz warm start (block-diag + analytic h1)
    must reach LAPACK-level accuracy through eigh_newton on a matrix with
    the exact RR structure: X-block diag, X-P coupling 0, X-W coupling
    residual-sized."""
    from gcge_tpu.solvers.gcg import _rr_struct_warm

    size_x, bs = 80, 10
    m = size_x + 2 * bs
    lam_x = np.sort(0.1 + rng.uniform(0, 5.0, size_x))
    h = np.zeros((m, m))
    h[np.arange(size_x), np.arange(size_x)] = lam_x
    hpp = rng.standard_normal((bs, bs)); hpp = 0.5 * (hpp + hpp.T) + 5 * np.eye(bs)
    hww = rng.standard_normal((bs, bs)); hww = 0.5 * (hww + hww.T) + 8 * np.eye(bs)
    h[size_x:size_x + bs, size_x:size_x + bs] = hpp
    h[size_x + bs:, size_x + bs:] = hww
    cpw = rng.standard_normal((bs, bs)) * 0.5
    h[size_x:size_x + bs, size_x + bs:] = cpw
    h[size_x + bs:, size_x:size_x + bs] = cpw.T
    # X-W coupling: residual-sized (steady-state scale)
    cxw = rng.standard_normal((size_x, bs)) * 1e-4
    h[:size_x, size_x + bs:] = cxw
    h[size_x + bs:, :size_x] = cxw.T

    hj = jnp.asarray(h)
    d0, u0, h1 = _rr_struct_warm(hj, size_x, bs)
    # analytic h1 must equal u0^T h u0
    h1_ref = np.asarray(u0).T @ h @ np.asarray(u0)
    assert np.abs(np.asarray(h1) - h1_ref).max() < 1e-11 * np.abs(h).max()
    w, u = eigh_newton(hj, warm=(d0, u0), warm_h1=h1, cluster_first=False)
    w_ref = np.linalg.eigh(h)[0]
    scale = np.abs(w_ref).max()
    assert np.abs(np.asarray(w) - w_ref).max() < 1e-11 * scale
    u = np.asarray(u)
    assert np.abs(h @ u - u * np.asarray(w)[None, :]).max() < 1e-10 * scale


def test_eigh_newton_overcap_tight_clusters_below_wide_run(rng):
    """The over-cap fix-up must target the over-cap run even when tight
    already-resolved clusters precede it in the spectrum (advisor round-1
    finding): three 1e-7-spaced pairs BELOW a 100-wide 1e-6-spaced run at
    cap=64, coarse (f32-level) warm start."""
    w_true = np.sort(np.concatenate([
        1.0 + np.repeat(np.arange(3) * 1e-3, 2) + np.tile([0, 1e-7], 3),
        2.0 + np.arange(100) * 1e-6,
        5.0 + np.arange(94) * 0.01,
    ]))
    m = len(w_true)
    q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    h = (q * w_true) @ q.T
    h = 0.5 * (h + h.T)
    w0, u0 = np.linalg.eigh(h.astype(np.float32).astype(np.float64))
    w, u = eigh_newton(jnp.asarray(h), cap=64,
                       warm=(jnp.asarray(w0), jnp.asarray(u0)), passes=3)
    err = np.abs(np.asarray(w) - w_true) / np.abs(w_true)
    assert err.max() < 1e-10, f"max rel eval err {err.max():.2e}"
