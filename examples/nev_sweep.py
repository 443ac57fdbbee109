#!/usr/bin/env python
"""nev sweep with the reference's production parameterization.

The analogue of the reference's cluster rig (``/root/reference/test/
submit.sh``): sweep the wanted eigenpair count with ``blockSize = nev/5``,
``nevMax = 2*nev``, ``-gcge_rel_tol 1e-8 -gcge_abs_tol 1`` (``:34-44``) on
the SiO2-scale 3D 27-point Laplacian stand-in and print one timing row per
configuration.

    python examples/nev_sweep.py [-nx 54] [-nevs 50,100,200] [-platform cpu|gpu]

The persistent compile cache is on (``gcge_tpu.utils.compile_cache``); each
new (nev, block) shape pays a one-time compile.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv):
    import jax

    from examples.gcge_solve import get_flag

    platform = get_flag(argv, "-platform")
    if platform:
        jax.config.update("jax_platforms",
                          "cuda" if platform == "gpu" else platform)
    jax.config.update("jax_enable_x64", True)
    from gcge_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()

    from gcge_tpu.io.stencil import laplacian_27pt
    from gcge_tpu.ops.operators import make_operator
    from gcge_tpu.solvers.gcg import GCGParams, gcg_solve

    nx = get_flag(argv, "-nx", 54, int)
    nevs = [int(v) for v in
            get_flag(argv, "-nevs", "50,100,200").split(",")]
    rows, cols, vals, n = laplacian_27pt(nx)
    op = make_operator(rows, cols, vals, (n, n))
    print(f"n={n} nnz={len(vals)}  (production params: bs=nev/5, "
          f"nevMax=2*nev, tol={{1,1e-8}}; submit.sh:34-44)")
    print(f"{'nev':>6} {'bs':>5} {'wall_s':>9} {'iters':>6} {'conv':>6}")
    for nev in nevs:
        params = GCGParams(nev=nev, block_size=max(nev // 5, 1), verbose=0,
                           tol_abs=1.0, tol_rel=1e-8, cg_max_iter=30,
                           fuse=10, cg_auto_shift=True)
        gcg_solve(op, None, params)              # compile (cached)
        t0 = time.perf_counter()
        r = gcg_solve(op, None, params)
        wall = time.perf_counter() - t0
        print(f"{nev:>6} {params.resolved(n).block_size:>5} {wall:>9.1f} "
              f"{r.num_iter:>6} {r.nev_conv:>6}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
