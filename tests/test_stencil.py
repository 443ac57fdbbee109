"""The 27-point Laplacian oracle, GCG on it, and the tools around the smoke
test: the compile-cache helper and ``chip_smoke.py``'s refusal to run off
the GPU.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import scipy.sparse as sps

from gcge_tpu.io.stencil import laplacian_27pt, laplacian_27pt_eigenvalues

ROOT = Path(__file__).resolve().parents[1]


def _csr(nx):
    r, c, v, n = laplacian_27pt(nx)
    return sps.csr_matrix((v, (r, c)), shape=(n, n))


@pytest.mark.parametrize("nx", [4, 5, 6])
def test_27pt_oracle_matches_dense_eigh(nx):
    """The closed-form spectrum equals dense eigh of the assembled matrix."""
    a = _csr(nx)
    n = nx ** 3
    assert a.shape == (n, n)
    assert abs(a - a.T).max() == 0.0
    assert np.all(a.diagonal() == 26.0)
    exact = laplacian_27pt_eigenvalues(nx, n)
    np.testing.assert_allclose(np.linalg.eigvalsh(a.toarray()), exact,
                               rtol=1e-12, atol=1e-12)


def test_27pt_bench_size_facts():
    """nx = 54 is the bench operator: n = 157,464, nnz = 4,096,000, and its
    smallest eigenvalue matches the reference library's measured one."""
    r, _, _, n = laplacian_27pt(54)
    assert n == 157_464 and len(r) == 4_096_000
    with open(ROOT / "BASELINE_MEASURED.json") as f:
        ref = json.load(f)["eigenvalues_first6"]
    np.testing.assert_allclose(laplacian_27pt_eigenvalues(54, 6), ref,
                               rtol=1e-10)


def _residuals(a, ev, evec, k):
    x = np.asarray(evec)[:, :k]
    lam = np.asarray(ev)[:k]
    return np.linalg.norm(a @ x - x * lam[None, :], axis=0) / np.abs(lam)


@pytest.mark.parametrize("fuse,mixed", [(0, False), (8, True)])
def test_gcg_27pt_oracle(fuse, mixed):
    """GCG on the 27-point Laplacian (DIA layout), phased with the plain f64
    inner CG and fused with the mixed one: eigenvalues match the closed
    form and every returned pair meets the tolerance it was declared at."""
    from gcge_tpu import GCGParams, gcg_solve, make_operator

    nx, nev = 8, 6
    r, c, v, n = laplacian_27pt(nx)
    op = make_operator(r, c, v, (n, n))
    res = gcg_solve(op, None, GCGParams(
        nev=nev, block_size=3, max_iter=150, fuse=fuse, cg_mixed=mixed,
        cg_auto_shift=mixed, verbose=0))
    assert res.nev_conv >= nev
    np.testing.assert_allclose(res.eval[:nev],
                               laplacian_27pt_eigenvalues(nx, nev),
                               rtol=1e-10)
    assert _residuals(_csr(nx), res.eval, res.evec, nev).max() <= 1e-8


@pytest.mark.parametrize("distribute", [False, "rows"])
def test_converged_pairs_rechecked_before_stopping(distribute):
    """A missed member of a degenerate cluster that turns up below the
    converged block shifts the converged vectors one slot up; the solver
    re-tests every pair before it stops, so all nev returned pairs meet the
    tolerance (at nx = 12 an unconverged vector used to be returned in slot
    1 with rel residual ~4e-8)."""
    import gcge_tpu

    nx, nev = 12, 8
    a = _csr(nx)
    ev, evec, nconv = gcge_tpu.solve(a, nev=nev, distribute=distribute,
                                     verbose=0)
    assert nconv >= nev
    assert _residuals(a, ev, evec, nev).max() <= 1e-8
    np.testing.assert_allclose(np.asarray(ev)[:nev],
                               laplacian_27pt_eigenvalues(nx, nev), rtol=1e-10)


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the helper sets nothing."""
    from gcge_tpu.utils import compile_cache

    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax.config, "update",
                        lambda *a, **k: calls.append(a))
    assert compile_cache.use_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_default_is_checkout(monkeypatch):
    """Without the variable the cache goes to <checkout>/.jax_cache, derived
    from the package's own location."""
    from gcge_tpu.utils import compile_cache

    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update",
                        lambda *a, **k: calls.append(a))
    path = compile_cache.use_compile_cache()
    assert path == str(ROOT / ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]


def _run_smoke(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    """On a CPU-only JAX the smoke test exits non-zero and prints no
    result line."""
    out = _run_smoke(ROOT, ROOT / "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory without the package, it fails too."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path, tmp_path / "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_result_line():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 4)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}


@pytest.mark.gpu
def test_gpu_bench_operator_first_pairs(gpu):
    """On the card: the bench operator's 10 smallest pairs through the
    public surface, against the closed form."""
    import gcge_tpu

    nx, nev = 54, 10
    a = _csr(nx)
    ev, evec, nconv = gcge_tpu.solve(a, nev=nev, verbose=0)
    assert list(evec.devices())[0].platform == "gpu"
    assert nconv >= nev
    np.testing.assert_allclose(np.asarray(ev)[:nev],
                               laplacian_27pt_eigenvalues(nx, nev), rtol=1e-10)
    assert _residuals(a, ev, evec, nev).max() <= 1e-8
