"""A/B parameter variants at the nev=50 bench: check_max / orth_passes."""
import sys as _s, os as _o; _s.path.insert(0, _o.path.dirname(_o.path.dirname(_o.path.abspath(__file__))))
import os, sys, time
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
base = dict(nev=50, block_size=10, max_iter=120, verbose=0, cg_max_iter=30,
            fuse=20, cg_mixed=True, cg_refine=2, cg_auto_shift=True)
variants = {
    "base": {},
    "check50": {"check_max": 50},
    "orthp1": {"orth_passes": 1},
}
which = sys.argv[1] if len(sys.argv) > 1 else "base"
params = GCGParams(**{**base, **variants[which]})
res = gcg_solve(dia64, None, params)
t0 = time.perf_counter()
res = gcg_solve(dia64, None, params)
wall = time.perf_counter() - t0
print(f"[{which}] steady: {wall:.2f}s iters={res.num_iter} nev_conv={res.nev_conv}")
print("eval[:3]:", np.asarray(res.eval[:3]))
