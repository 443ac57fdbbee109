"""Irregular-matrix production benchmark.

The reference's benchmark rig is SuiteSparse irregular matrices
(``/root/reference/test/submit.sh:9-15``, SiO2: n=155k nnz=11.3M) — not
fetchable without network.  Stand-in: a P1 FEM stiffness matrix on
an UNSTRUCTURED Delaunay tet mesh (``io.fem.random_delaunay_mesh``) — after
RCM its nonzeros land on thousands of distinct diagonals (top-128 cover only
~40%), a genuinely SiO2-class pattern that the DIA fast path cannot carry.

Stages:
  1. build/cache the mesh + assembled pair (host, one-time);
  2. RCM reorder; report pattern statistics + the layout make_operator picks;
  3. measure SpMM throughput at bs=10/40;
  4. solve nev=50 (and optionally nev=200: IRREG_NEV=200) end-to-end;
  5. write CSC binaries for the reference measurement:
       native/ref_bench -matA .scratch/irreg_a_g64.bin -nev 50

Usage: python benchmarks/irregular.py  [IRREG_G=64 IRREG_NEV=50]
"""
import os
import sys as _s, os as _o; _s.path.insert(0, _o.path.dirname(_o.path.dirname(_o.path.abspath(__file__))))
import time

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_enable_x64", True)
from gcge_tpu.utils.compile_cache import use_compile_cache
use_compile_cache()

G = int(os.environ.get("IRREG_G", 64))          # jittered-grid resolution
NEV = int(os.environ.get("IRREG_NEV", 50))
SCRATCH = _o.path.join(_o.path.dirname(_o.path.dirname(_o.path.abspath(__file__))),
                       ".scratch")
CACHE = _o.path.join(SCRATCH, f"irreg_mesh_g{G}.npz")


def build_pair():
    from gcge_tpu.io.fem import assemble_p1, random_delaunay_mesh

    os.makedirs(SCRATCH, exist_ok=True)
    if os.path.exists(CACHE):
        d = np.load(CACHE)
        return d["rows"], d["cols"], d["av"], d["bv"], int(d["n"])
    t0 = time.time()
    verts, tets, bnd = random_delaunay_mesh(G ** 3, seed=1)
    print(f"mesh: {len(verts)} verts {len(tets)} tets ({time.time()-t0:.0f}s)",
          flush=True)
    t0 = time.time()
    rows, cols, av, bv, n = assemble_p1(verts, tets, bnd)
    print(f"assembled n={n} nnz={len(rows)} ({time.time()-t0:.0f}s)", flush=True)
    np.savez(CACHE, rows=rows, cols=cols, av=av, bv=bv, n=n)
    return rows, cols, av, bv, n


def main():
    import scipy.sparse as sps
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    from gcge_tpu.io.loaders import write_ccs_binary
    from gcge_tpu.ops.operators import make_operator
    from gcge_tpu.solvers.gcg import GCGParams, gcg_solve

    rows, cols, av, bv, n = build_pair()
    nnz = len(rows)
    a = sps.coo_matrix((av, (rows, cols)), shape=(n, n)).tocsr()
    perm = reverse_cuthill_mckee(a, symmetric_mode=True)
    inv = np.empty_like(perm); inv[perm] = np.arange(n)
    r2, c2 = inv[rows], inv[cols]
    offs = c2 - r2
    uniq, counts = np.unique(offs, return_counts=True)
    order = np.argsort(-counts)
    cov128 = counts[order[:128]].sum() / nnz
    deg = np.bincount(r2, minlength=n)
    print(f"pattern: n={n} nnz={nnz} ({nnz/n:.1f}/row) band={np.abs(offs).max()}"
          f" diags={len(uniq)} top128cov={cov128:.2f} degmax={deg.max()}",
          flush=True)

    # write reference inputs once
    ref_path = os.path.join(SCRATCH, f"irreg_a_g{G}.bin")
    if not os.path.exists(ref_path):
        write_ccs_binary(ref_path, r2, c2, av, n)
        print(f"wrote {ref_path}  (run: native/ref_bench -matA {ref_path} "
              f"-nev {NEV})", flush=True)

    op = make_operator(r2, c2, av, (n, n))
    print("layout:", type(op).__name__, flush=True)

    # SpMM throughput (f64 gather path + the one-hot f32 planes if present)
    _sum = jax.jit(lambda x: jnp.sum(x.astype(jnp.float32)))
    for bs in (10, 40):
        x = jnp.asarray(np.random.default_rng(0).standard_normal((n, bs)))
        mv = jax.jit(lambda xx: op.matvec(xx))
        float(_sum(mv(x)))
        t0 = time.perf_counter()
        for _ in range(10):
            y = mv(x)
        float(_sum(y))
        dt_s = (time.perf_counter() - t0) / 10
        print(f"spmm bs={bs} f64-ell: {dt_s*1e3:.2f} ms  "
              f"{nnz/dt_s/1e9:.2f} Gnnz/s", flush=True)

    # cg 60x3: a deeper inner budget (the reference's own scale-tuning
    # range, submit.sh:18-19 uses 35-60) gives better W corrections per
    # outer iteration on this matrix.
    precond = None
    mg = int(os.environ.get("IRREG_MG", 0))   # >0: AMG-preconditioned inner CG
    if mg:
        from gcge_tpu.solvers.multigrid import (bamg_preconditioner,
                                                build_hierarchy)

        t0 = time.perf_counter()
        hier = build_hierarchy(r2, c2, av, n, max_levels=mg)
        precond = bamg_preconditioner(hier)
        print(f"AMG setup: {time.perf_counter()-t0:.1f}s "
              f"levels={hier.num_levels}", flush=True)
    params = GCGParams(nev=NEV, block_size=max(NEV // 5, 1), max_iter=300,
                       verbose=1,
                       cg_max_iter=int(os.environ.get("IRREG_CG", 60)),
                       cg_refine=int(os.environ.get("IRREG_REFINE", 3)),
                       fuse=10,
                       linear_precond=precond,
                       cg_mixed=os.environ.get("IRREG_MIXED", "1") == "1",
                       cg_auto_shift=os.environ.get("IRREG_SHIFT", "1") == "1")
    t0 = time.perf_counter()
    res = gcg_solve(op, None, params)
    wall = time.perf_counter() - t0
    print(f"IRREGULAR nev={NEV}: wall={wall:.1f}s iters={res.num_iter} "
          f"conv={res.nev_conv}", flush=True)
    if os.environ.get("IRREG_ONESHOT", "0") == "1":
        return
    t0 = time.perf_counter()
    res = gcg_solve(op, None, params)
    wall = time.perf_counter() - t0
    print(f"IRREGULAR nev={NEV} steady: wall={wall:.1f}s iters={res.num_iter} "
          f"conv={res.nev_conv} eval[:4]={np.asarray(res.eval[:4])}", flush=True)


if __name__ == "__main__":
    main()
