"""Phase-timer profile: nev=50 bench operator, fuse=0 (one dispatch per phase)."""
import sys as _s, os as _o; _s.path.insert(0, _o.path.dirname(_o.path.dirname(_o.path.abspath(__file__))))
import os, time
import jax
jax.config.update("jax_enable_x64", True)
from gcge_tpu.utils.compile_cache import use_compile_cache
use_compile_cache()
import numpy as np
from gcge_tpu.io.stencil import laplacian_27pt
from gcge_tpu.ops.operators import make_operator
from gcge_tpu.solvers.gcg import GCGParams, gcg_solve

rows, cols, vals, n = laplacian_27pt(54)
dia64 = make_operator(rows, cols, vals, (n, n))
params = GCGParams(nev=50, block_size=10, max_iter=30, verbose=1,
                   cg_max_iter=30, fuse=0, cg_mixed=True, cg_refine=2,
                   cg_auto_shift=True)
t0 = time.perf_counter()
res = gcg_solve(dia64, None, params)
print(f"wall {time.perf_counter()-t0:.1f}s iters={res.num_iter} conv={res.nev_conv}")
for k, v in res.timers.items():
    print(f"  {k:10s} {v:7.2f}s  {v/max(res.num_iter,1)*1e3:7.1f} ms/iter")
