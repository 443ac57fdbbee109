import os, time
import sys as _s, os as _o; _s.path.insert(0, _o.path.dirname(_o.path.dirname(_o.path.abspath(__file__))))
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
params = GCGParams(nev=200, block_size=40, max_iter=150, verbose=0,
                   cg_max_iter=30, fuse=20, cg_mixed=True, cg_refine=2,
                   cg_auto_shift=True)
t0 = time.perf_counter()
res = gcg_solve(dia64, None, params)
print(f"cold: {time.perf_counter()-t0:.1f}s iters={res.num_iter} conv={res.nev_conv}")
t0 = time.perf_counter()
res = gcg_solve(dia64, None, params)
print(f"steady: {time.perf_counter()-t0:.1f}s iters={res.num_iter} conv={res.nev_conv}")
