"""Benchmark harness — prints ONE JSON line.

Headline metric (BASELINE.md north star): wall-clock to 50 eigenpairs at
rel-residual 1e-8 on a SiO2-scale symmetric operator, one GPU, vs the
MEASURED reference.  SiO2 itself (SuiteSparse, n=155,331, nnz≈11.3M) is not
fetchable without network; the stand-in is the 3D 27-point Laplacian on a
54^3 grid (n=157,464, nnz=4,096,000, ``gcge_tpu.io.stencil``) — the same
row-density regime as the reference's benchmark family
(reference ``test/submit.sh:9-15``).

``vs_baseline`` is measured, not cited: ``native/ref_bench`` runs the
UNMODIFIED reference C library (GCG + CCS backend, netlib BLAS, serial — the
1-rank configuration of its rig) on the identical operator and production
parameters on a CPU host.  The measurement is cached in
``BASELINE_MEASURED.json``, which is all this script reads; refreshing it is
a manual CPU-host step (``make -C native ref_bench`` against a reference
checkout, then ``native/ref_bench -nx 54 -nev 50``).

Also reported on stderr: the card's name and power limit, and the SpMM sweep
(nnz/s per layout and precision, with the scipy-CSR CPU rate for context).
Needs a GPU; exits non-zero on any other device.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def reference_baseline(nx: int, nev: int) -> dict | None:
    """Measured reference wall time from the cached BASELINE_MEASURED.json."""
    with open(os.path.join(REPO, "BASELINE_MEASURED.json")) as f:
        meta = json.load(f)
    if f"nx={nx}" in meta.get("problem", "") and f"nev={nev}" in meta.get(
            "parameters", ""):
        return meta
    return None


def gpu_device():
    """The first device, which must be a GPU; prints what it is."""
    import jax

    d0 = jax.devices()[0]
    if d0.platform != "gpu":
        raise SystemExit(f"bench: needs a GPU; JAX found platform="
                         f"{d0.platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"device: {d0.device_kind} x{len(jax.devices())}; nvidia-smi: {smi}")
    return {"platform": d0.platform, "kind": d0.device_kind,
            "count": len(jax.devices()), "nvidia_smi": smi}


def spmm_sweep(rows, cols, vals, n, nnz, bs, x_np):
    """Per-layout SpMM throughput (stderr, informational)."""
    import jax
    import jax.numpy as jnp

    from gcge_tpu.ops.operators import DiaOperator, SparseOperator

    def chain_time(matvec, x, k=50):
        # norm-preserving chain: the iterate is rescaled to unit RMS every
        # step, so the kernel is always timed on full-range inputs
        def body(i, y):
            z = matvec(y)
            return z * jax.lax.rsqrt(jnp.mean(jnp.square(z)) + 1e-30)
        g = jax.jit(lambda xx: jax.lax.fori_loop(0, k, body, xx))
        jax.block_until_ready(g(x))
        t0 = time.perf_counter()
        jax.block_until_ready(g(x))
        return (time.perf_counter() - t0) / k

    results = {}
    for dt in ("float64", "float32"):
        x = jnp.asarray(x_np, dtype=dt)
        dia = DiaOperator.from_coo(rows, cols, vals, (n, n), dtype=jnp.dtype(dt))
        t = chain_time(dia.matvec, x)
        results[f"dia_{dt}"] = nnz * bs / t
        log(f"  DIA  {dt}: {t*1e3:.4f} ms -> {results[f'dia_{dt}']/1e9:.2f} Gnnz/s")
    x32 = jnp.asarray(x_np, jnp.float32)
    ell = SparseOperator.from_coo(rows, cols, vals, (n, n), dtype=jnp.float32)
    t = chain_time(ell.matvec, x32)
    results["ell_float32"] = nnz * bs / t
    log(f"  ELL  float32: {t*1e3:.4f} ms -> {results['ell_float32']/1e9:.2f} Gnnz/s")
    return results


def main():
    nx, nev, bs = 54, 50, 10

    import jax

    jax.config.update("jax_enable_x64", True)
    from gcge_tpu.utils.compile_cache import use_compile_cache

    device = gpu_device()
    cache_dir = use_compile_cache()

    from gcge_tpu.io.stencil import laplacian_27pt

    log(f"building 3D 27-point Laplacian nx={nx} ...")
    rows, cols, vals, n = laplacian_27pt(nx)
    nnz = len(vals)
    log(f"n={n} nnz={nnz}")

    # ---- scipy CPU SpMM rate (context) -----------------------------------
    import scipy.sparse as sps

    a_csr = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    x_np = np.random.default_rng(0).standard_normal((n, bs))
    a_csr @ x_np
    t0 = time.perf_counter()
    for _ in range(5):
        a_csr @ x_np
    cpu_dt = (time.perf_counter() - t0) / 5
    log(f"CPU scipy CSR SpMM (f64, bs={bs}): {cpu_dt*1e3:.2f} ms -> "
        f"{nnz * bs / cpu_dt / 1e9:.3f} Gnnz/s")

    # ---- measured reference baseline -------------------------------------
    ref = reference_baseline(nx, nev)
    if ref:
        log(f"reference GCG baseline (1 CPU core, serial C library): "
            f"{ref['wall_s']:.1f}s, {ref['num_iter']} iters, "
            f"nevConv={ref['nev_conv']}")

    from gcge_tpu.ops.operators import make_operator
    from gcge_tpu.solvers.gcg import GCGParams, gcg_solve

    spmm_sweep(rows, cols, vals, n, nnz, bs, x_np)

    # ---- headline: GCG wall-clock to nev eigenpairs at rel 1e-8 -----------
    dia64 = make_operator(rows, cols, vals, (n, n))
    # cg_max_iter=30 matches the reference's compW_cg_max_iter budget
    # (test/submit.sh:18-19 uses 35-60; the driver default is 30); the mixed
    # path splits it into cg_refine f32 CG stages with f64 residual
    # refreshes between.
    params = GCGParams(nev=nev, block_size=bs, max_iter=120, verbose=0,
                       cg_max_iter=30, fuse=20, cg_mixed=True, cg_refine=2,
                       cg_auto_shift=True)
    # with a populated on-disk cache the first call measures cache
    # DESERIALIZATION, not compile cost
    n_cached = len(os.listdir(cache_dir)) if os.path.isdir(cache_dir) else 0
    cold_kind = "cache-warm first call" if n_cached else "cold first call"
    log(f"persistent compile cache {cache_dir}: {n_cached} entries -> the "
        f"next number is a {cold_kind}")
    t0 = time.perf_counter()
    res = gcg_solve(dia64, None, params)
    jax.block_until_ready(res.evec)
    cold = time.perf_counter() - t0
    log(f"GPU GCG nev={nev} {cold_kind}: {cold:.3f}s, {res.num_iter} iters, "
        f"nev_conv={res.nev_conv}")
    # steady state: compile amortized (the C reference's analogous cost —
    # gcc -O3 of the library — is likewise not timed)
    t0 = time.perf_counter()
    res = gcg_solve(dia64, None, params)
    jax.block_until_ready(res.evec)
    wall = time.perf_counter() - t0
    log(f"GPU GCG nev={nev} steady-state: {wall:.4f}s, {res.num_iter} iters, "
        f"nev_conv={res.nev_conv}")

    converged = res.nev_conv >= nev
    vs = (ref["wall_s"] / wall) if (ref and converged) else 0.0
    print(json.dumps({
        "metric": "gcg_wall_s_50pairs_rel1e-8_157k",
        "value": wall,
        "unit": "s",
        "vs_baseline": vs,
        "device": device,
    }))


if __name__ == "__main__":
    main()
