#!/usr/bin/env python
"""Smoke test of the eigensolver on NVIDIA GPUs, through the public entry points.

    python chip_smoke.py           # phases 1-4 on one GPU
    python chip_smoke.py --four    # only the row-sharded 1M-row solve, 4 GPUs

Phases (one process; any failure raises and exits non-zero):

1. device: JAX must report a GPU; prints its kind, the device count and
   ``nvidia-smi --query-gpu=name,power.limit``.  No CPU fallback.
2. main path, tuned parameters: ``gcg_solve(make_operator(...))`` on the 3D
   27-point Laplacian at nx = 54 (n = 157,464, nnz = 4,096,000), nev = 50 at
   the reference's production parameterization (bs = 10, nevMax = 100,
   rel-tol 1e-8, 30 inner CG steps), fused chunks and the mixed f32/f64
   inner CG.
3. main path, public surface: ``gcge_tpu.solve(A, nev=50)`` with default
   parameters (phased dispatch, plain f64 inner CG).
4. generalized problem: the P1 FEM cube pair (consistent mass matrix) at
   nx = 40, nev = 20, through ``gcge_tpu.solve(A, B, nev=20)``.
5. ``--four`` instead runs BASELINE.json config 5 (nx = 100, n = 1,000,000,
   nev = 100) with ``distribute="rows"`` and on a 2x2 ``"grid"`` mesh, and
   checks that the operator and the basis are split over the devices.

Checks and their tolerances:

* eigenvalues against the exact 27-point spectrum to rel 1e-10: the
  eigenvalue error of a Ritz pair is quadratic in its residual, so pairs
  converged to rel-residual 1e-8 sit far below this;
* the first six against ``BASELINE_MEASURED.json`` (the reference C
  library, printed to 13 digits) to rel 1e-10;
* host residuals ``max ||A x - lambda B x|| / |lambda| <= 1e-8``, recomputed in
  f64 with scipy CSR: the solver's own convergence test, redone off-device;
* ``||X^T B X - I||_2 <= 1e-10``: the basis is B-orthonormalized in f64 every
  iteration, so its error is rounding-sized;
* FEM eigenvalues against ``scipy.sparse.linalg.eigsh(A, M=B, sigma=0)`` to
  rel 1e-9 (eigsh run at tol 1e-12).

The last line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from gcge_tpu.utils.compile_cache import CHECKOUT, use_compile_cache  # noqa: E402

EV_RTOL = 1e-10
RES_RTOL = 1e-8
ORTH_TOL = 1e-10
FEM_EV_RTOL = 1e-9


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)
    log(f"   ok: {what}")


def device_phase(want: int):
    import jax

    devs = jax.devices()
    d0 = devs[0]
    if d0.platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU; JAX found "
                         f"platform={d0.platform!r}")
    if len(devs) < want:
        raise SystemExit(f"chip_smoke: needs {want} GPUs, found {len(devs)}")
    log(f"== phase 1: device  kind={d0.device_kind}  count={len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    for line in smi.strip().splitlines():
        log(f"nvidia-smi: {line.strip()}")
    return d0, len(devs)


def host_residual(a_csr, b_csr, lam, x) -> float:
    ax = a_csr @ x
    bx = x if b_csr is None else b_csr @ x
    r = np.linalg.norm(ax - bx * lam[None, :], axis=0)
    return float(np.max(r / np.abs(lam)))


def check_stencil(tag, nx, ev, evec, nev, a_csr):
    from gcge_tpu.io.stencil import laplacian_27pt_eigenvalues

    exact = laplacian_27pt_eigenvalues(nx, nev)
    ev = np.asarray(ev)[:nev]
    rel = float(np.max(np.abs(ev - exact) / np.abs(exact)))
    log(f"   {tag}: lambda_0 = {ev[0]:.15e}, max rel err vs exact "
        f"spectrum {rel:.3e}")
    check(rel <= EV_RTOL, f"{tag}: {nev} eigenvalues within {EV_RTOL:g} of "
          f"the exact spectrum")
    x = np.asarray(evec)[:, :nev]
    res = host_residual(a_csr, None, ev, x)
    log(f"   {tag}: host max ||Ax - lambda x||/|lambda| = {res:.3e}")
    check(res <= RES_RTOL, f"{tag}: host residuals <= {RES_RTOL:g}")


def check_baseline(tag, ev):
    with open(CHECKOUT / "BASELINE_MEASURED.json") as f:
        ref = np.asarray(json.load(f)["eigenvalues_first6"])
    rel = float(np.max(np.abs(np.asarray(ev)[:6] - ref) / ref))
    log(f"   {tag}: max rel err vs reference library's first 6: {rel:.3e}")
    check(rel <= EV_RTOL, f"{tag}: first 6 within {EV_RTOL:g} of "
          f"BASELINE_MEASURED.json")


def stencil_problem(nx):
    import scipy.sparse as sps

    from gcge_tpu.io.stencil import laplacian_27pt

    rows, cols, vals, n = laplacian_27pt(nx)
    a_csr = sps.csr_matrix((vals, (rows, cols)), shape=(n, n))
    return rows, cols, vals, n, a_csr


def tuned_phase(nx=54, nev=50):
    import jax

    from gcge_tpu import GCGParams, gcg_solve, make_operator

    log(f"== phase 2: gcg_solve, tuned parameters (nx={nx}, nev={nev})")
    rows, cols, vals, n, a_csr = stencil_problem(nx)
    log(f"   n={n} nnz={len(vals)}")
    a_op = make_operator(rows, cols, vals, (n, n))
    log(f"   operator: {type(a_op).__name__}")
    params = GCGParams(nev=nev, block_size=10, max_iter=120, cg_max_iter=30,
                       fuse=20, cg_mixed=True, cg_refine=2,
                       cg_auto_shift=True, verbose=0)
    walls = []
    for label in ("cold", "steady"):
        t0 = time.perf_counter()
        res = gcg_solve(a_op, None, params)
        jax.block_until_ready(res.evec)
        walls.append(time.perf_counter() - t0)
        log(f"   {label}: {walls[-1]:.3f} s, {res.num_iter} iterations, "
            f"nev_conv={res.nev_conv}")
    check(res.nev_conv >= nev, f"nev_conv {res.nev_conv} >= {nev}")
    check_stencil("tuned", nx, res.eval, res.evec, nev, a_csr)
    check_baseline("tuned", res.eval)
    return walls


def public_phase(nx=54, nev=50):
    import jax

    import gcge_tpu

    log(f"== phase 3: gcge_tpu.solve, default parameters (nx={nx}, "
        f"nev={nev})")
    _, _, _, _, a_csr = stencil_problem(nx)
    t0 = time.perf_counter()
    ev, evec, nconv = gcge_tpu.solve(a_csr, nev=nev, verbose=0)
    jax.block_until_ready(evec)
    log(f"   wall (compile included): {time.perf_counter() - t0:.3f} s, "
        f"nev_conv={nconv}")
    check(nconv >= nev, f"nev_conv {nconv} >= {nev}")
    check_stencil("public", nx, ev, evec, nev, a_csr)
    check_baseline("public", ev)


def fem_phase(nx=40, nev=20):
    import jax
    import scipy.sparse as sps
    from scipy.sparse.linalg import eigsh

    import gcge_tpu
    from gcge_tpu.io.fem import cube_fem_laplacian

    log(f"== phase 4: generalized FEM pair (nx={nx}, nev={nev})")
    rows, cols, a_vals, b_vals, n = cube_fem_laplacian(nx)
    a = sps.csr_matrix((a_vals, (rows, cols)), shape=(n, n))
    b = sps.csr_matrix((b_vals, (rows, cols)), shape=(n, n))
    log(f"   n={n} nnz={a.nnz}")
    t0 = time.perf_counter()
    ev, evec, nconv = gcge_tpu.solve(a, b, nev=nev, verbose=0)
    jax.block_until_ready(evec)
    log(f"   wall (compile included): {time.perf_counter() - t0:.3f} s, "
        f"nev_conv={nconv}")
    check(nconv >= nev, f"nev_conv {nconv} >= {nev}")
    ev = np.asarray(ev)[:nev]
    x = np.asarray(evec)[:, :nev]
    res = host_residual(a, b, ev, x)
    log(f"   host max ||Ax - lambda Bx||/|lambda| = {res:.3e}")
    check(res <= RES_RTOL, f"FEM host residuals <= {RES_RTOL:g}")
    orth = float(np.linalg.norm(x.T @ (b @ x) - np.eye(nev), 2))
    log(f"   ||X^T B X - I||_2 = {orth:.3e}")
    check(orth <= ORTH_TOL, f"B-orthonormality <= {ORTH_TOL:g}")
    ref = np.sort(eigsh(a, k=nev, M=b, sigma=0, which="LM", tol=1e-12,
                        return_eigenvectors=False))
    rel = float(np.max(np.abs(ev - ref) / np.abs(ref)))
    log(f"   max rel err vs scipy eigsh: {rel:.3e}")
    check(rel <= FEM_EV_RTOL, f"FEM eigenvalues within {FEM_EV_RTOL:g} of "
          f"scipy eigsh")


def four_phase(nx=100, nev=100):
    import jax

    import gcge_tpu
    import gcge_tpu.parallel as par

    log(f"== four GPUs: row-sharded solve (nx={nx}, nev={nev})")
    _, _, _, n, a_csr = stencil_problem(nx)
    log(f"   n={n} nnz={a_csr.nnz}")
    ndev = len(jax.devices())
    sharded = []
    shard_operator = par.shard_operator

    def spy(op, mesh):
        out = shard_operator(op, mesh)
        sharded.append(out)
        return out

    par.shard_operator = spy
    try:
        for mode in ("rows", "grid"):
            sharded.clear()
            t0 = time.perf_counter()
            ev, evec, nconv = gcge_tpu.solve(a_csr, nev=nev,
                                             distribute=mode, verbose=0)
            jax.block_until_ready(evec)
            log(f"   {mode}: wall (compile included) "
                f"{time.perf_counter() - t0:.3f} s, nev_conv={nconv}")
            check(nconv >= nev, f"{mode}: nev_conv {nconv} >= {nev}")
            check_stencil(mode, nx, ev, evec, nev, a_csr)
            row_ways = ndev if mode == "rows" else ndev // 2
            a_op = sharded[0]
            vals = a_op.inner.values
            a_rows = {s.device.id: s.data.shape[1]
                      for s in vals.addressable_shards}
            log(f"   {mode}: A rows per device {a_rows}, mesh "
                f"{dict(a_op.mesh.shape)}")
            check(len(a_rows) == ndev
                  and all(r == n // row_ways for r in a_rows.values()),
                  f"{mode}: A split {row_ways} ways by rows over {ndev} "
                  f"devices")
            v_blocks = {s.device.id: s.data.shape
                        for s in evec.addressable_shards}
            log(f"   {mode}: Ritz block per device {v_blocks}")
            check(len(v_blocks) == ndev
                  and all(shape[0] == n // row_ways
                          for shape in v_blocks.values()),
                  f"{mode}: basis split {row_ways} ways by rows over "
                  f"{ndev} devices")
    finally:
        par.shard_operator = shard_operator


def result_line(platform: str, kind: str, count: int) -> str:
    """The last line of standard output: one JSON object naming the device."""
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the row-sharded solve on four GPUs")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)
    want = 4 if args.four else 1
    d0, count = device_phase(want)
    log(f"compile cache: {use_compile_cache()}")
    if args.four:
        four_phase()
    else:
        tuned_phase()
        public_phase()
        fem_phase()
    print(result_line(d0.platform, d0.device_kind, count), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
