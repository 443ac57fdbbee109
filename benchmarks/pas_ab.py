"""A/B: PAS vs GCG+AMG-preconditioning on a >=3-level hierarchy — an A/B
showing where PAS wins.

Problem: 3D 27-point Laplacian at production n (the bench.py operator),
nev = PAS_NEV (default 50).  Both solvers run through the public api.solve
surface so the comparison includes everything a user gets.

Usage: python benchmarks/pas_ab.py          [PAS_NX=54 PAS_NEV=50]
"""
import os
import sys as _s, os as _o; _s.path.insert(0, _o.path.dirname(_o.path.dirname(_o.path.abspath(__file__))))
import time

import jax
import numpy as np

jax.config.update("jax_enable_x64", True)
from gcge_tpu.utils.compile_cache import use_compile_cache
use_compile_cache()

import scipy.sparse as sps

from gcge_tpu.io.stencil import laplacian_27pt
from gcge_tpu import solve

NX = int(os.environ.get("PAS_NX", 54))
NEV = int(os.environ.get("PAS_NEV", 50))

rows, cols, vals, n = laplacian_27pt(NX)
a = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
print(f"n={n} nnz={a.nnz} nev={NEV}", flush=True)


def run(tag, **kw):
    for rep in ("cold", "steady"):
        t0 = time.perf_counter()
        lam, vec, nconv = solve(a, nev=NEV, verbose=0, tol_rel=1e-8, **kw)
        wall = time.perf_counter() - t0
        print(f"{tag:28s} {rep:6s} wall={wall:7.1f}s conv={nconv} "
              f"lam[0]={lam[0]:.8e}", flush=True)


run("gcg plain", )
run("gcg + AMG precond", multigrid=4)
run("pas", method="pas", multigrid=4)
run("pas (deep sweeps)", method="pas", multigrid=4, pas_final_sweeps=24,
    pas_cycles=6)
