"""Distributed PAS vs distributed GCG(+AMG) at moderate scale — PAS at its
design point.

The reference's PAS rationale is multi-node scale: fine-level work becomes
communication-bound and the multilevel correction structure moves most
iterations to coarse levels (``ops_eig_sol_pas.c:534-730``).  This driver
runs the three distributed variants over an 8-virtual-device row mesh at
n=512k / 3-4 levels through the public api.solve surface and records
wall + converged counts.  One physical core drives all 8 virtual devices,
so the walls measure WORK (not parallel speed) and collectives are
near-free — the regime maximally favorable to flat GCG; the recorded
comparison is an upper bound on how well PAS can do on a CPU host.

Usage: python benchmarks/pas_dist_ab.py   [PAS_NX=80 PAS_NEV=50 PAS_DEV=8]
"""
import os
import sys as _s, os as _o; _s.path.insert(0, _o.path.dirname(_o.path.dirname(_o.path.abspath(__file__))))

NDEV = int(os.environ.get("PAS_DEV", 8))
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={NDEV}").strip()

import time

import jax

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", "cpu")
import numpy as np
import scipy.sparse as sps

from gcge_tpu.io.stencil import laplacian_27pt
from gcge_tpu import solve

NX = int(os.environ.get("PAS_NX", 80))
NEV = int(os.environ.get("PAS_NEV", 50))

assert len(jax.devices()) >= NDEV, jax.devices()
rows, cols, vals, n = laplacian_27pt(NX)
a = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
print(f"n={n} nnz={a.nnz} nev={NEV} devices={NDEV} (virtual, 1 core)",
      flush=True)


def run(tag, **kw):
    t0 = time.perf_counter()
    lam, vec, nconv = solve(a, nev=NEV, verbose=0, tol_rel=1e-8,
                            distribute="rows", **kw)
    wall = time.perf_counter() - t0
    print(f"{tag:32s} wall={wall:7.1f}s conv={nconv} "
          f"lam[0]={lam[0]:.8e}", flush=True)


run("dist gcg plain")
run("dist gcg + AMG precond", multigrid=4)
run("dist pas", method="pas", multigrid=4)
