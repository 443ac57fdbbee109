#!/usr/bin/env python
"""Command-line eigensolver driver — the analogue of the reference's
``test/main.c`` + ``test_eig_sol_gcg.c`` drivers.

Usage:
    python examples/gcge_solve.py -filename_matA A.mtx [-filename_matB B.mtx]
        [-nevConv 50] [-blockSize 10] [-gcge_rel_tol 1e-8] [-gcge_abs_tol 1]
        [-rcm 1] [-mesh 0] [-fuse 8] [-gcge_print_usage 1] ...

Accepts the reference's ``-gcge_*`` flag namespace (see
``gcge_tpu/utils/cli.py``), loads MatrixMarket (.mtx/.mtx.gz) or PETSc binary
matrices with the native toolkit, optionally RCM-reorders for the DIA fast
path, and solves with GCG — distributed over all devices with ``-mesh 1``.

With no ``-filename_matA`` a built-in 3D FEM Laplacian/mass pair is assembled
(``-fem_nx`` controls size) — the cube4.dat test configuration.
"""

import os
import sys
import time

import numpy as np

# allow running straight from a checkout: python examples/gcge_solve.py ...
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def get_flag(argv, name, default=None, conv=str):
    if name in argv:
        return conv(argv[argv.index(name) + 1])
    return default


def main(argv):
    import jax

    # -platform cpu|gpu (default: JAX's own choice)
    platform = get_flag(argv, "-platform")
    if platform:
        jax.config.update("jax_platforms",
                          "cuda" if platform == "gpu" else platform)
    jax.config.update("jax_enable_x64", True)
    from gcge_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()

    from gcge_tpu.io.fem import cube_fem_laplacian
    from gcge_tpu.io.loaders import load_petsc_binary
    from gcge_tpu.io.native import (
        apply_permutation,
        load_matrix_market_native,
        rcm_permutation,
        structure_stats,
    )
    from gcge_tpu.ops.operators import make_operator
    from gcge_tpu.utils.cli import params_from_args, print_usage

    if get_flag(argv, "-gcge_print_usage", 0, int):
        print_usage()

    path_a = get_flag(argv, "-filename_matA")
    path_b = get_flag(argv, "-filename_matB")
    use_rcm = get_flag(argv, "-rcm", 1, int)
    use_mesh = get_flag(argv, "-mesh", 0, int)
    fuse = get_flag(argv, "-fuse", 8, int)

    t0 = time.time()
    if path_a:
        def load(p):
            if p.endswith((".mtx", ".mtx.gz")):
                return load_matrix_market_native(p)
            return load_petsc_binary(p)

        rows, cols, vals, shape = load(path_a)
        n = shape[0]
        b_trip = None
        if path_b:
            rb, cb, vb, _ = load(path_b)
            b_trip = (rb, cb, vb)
    else:
        nx = get_flag(argv, "-fem_nx", 12, int)
        rows, cols, vals, b_vals, n = cube_fem_laplacian(nx)
        b_trip = (rows, cols, b_vals)
    print(f"loaded n={n} nnz={len(vals)} in {time.time()-t0:.2f}s")
    print("structure:", structure_stats(rows, cols, n))

    if use_rcm:
        before = structure_stats(rows, cols, n)
        perm = rcm_permutation(rows, cols, n)
        r2, c2, v2 = apply_permutation(rows, cols, vals, perm)
        after = structure_stats(r2, c2, n)
        # keep whichever ordering is better for the DIA fast path: fewer
        # diagonals first (natural stencil orderings win), bandwidth second
        better = (min(after["n_diagonals"], 65), after["bandwidth"]) < \
                 (min(before["n_diagonals"], 65), before["bandwidth"])
        if better:
            rows, cols, vals = r2, c2, v2
            if b_trip is not None:
                rb, cb, vb = b_trip
                b_trip = apply_permutation(rb, cb, vb, perm)
            print("after RCM:", after)
        else:
            print("RCM skipped (natural ordering already better):", after)

    a_op = make_operator(rows, cols, vals, (n, n))
    b_op = None
    if b_trip is not None:
        rb, cb, vb = b_trip
        b_op = make_operator(rb, cb, vb, (n, n))

    # -shift sigma: solve (A + sigma*B) x = mu x instead (the reference
    # driver's pre-shift, test_app_slepc.c:474-508) — functional, A is
    # never mutated (ShiftedOperator)
    shift = get_flag(argv, "-shift", 0.0, float)
    if shift:
        from gcge_tpu.ops.operators import ShiftedOperator

        a_op = ShiftedOperator(a_op, b_op, shift)
        print(f"operator shifted: A + {shift}*B")
    print(f"A layout: {type(a_op).__name__}"
          + (f", B layout: {type(b_op).__name__}" if b_op else ", B = I"))

    params, extras = params_from_args(argv)
    params = type(params)(**{**params.__dict__, "fuse": fuse})

    mesh = None
    if use_mesh:
        from gcge_tpu.parallel import pad_problem, row_mesh, shard_operator

        nd = len(jax.devices())
        mesh = row_mesh(nd)
        a_op, b_op, _ = pad_problem(a_op, b_op, nd)
        a_op = shard_operator(a_op, mesh)
        b_op = shard_operator(b_op, mesh) if b_op is not None else None
        print(f"distributed over {nd} devices")

    from gcge_tpu.solvers.gcg import gcg_solve

    # -profile_dir DIR: capture a jax.profiler trace of the solve (the
    # analogue of the reference's TIME_GCG tables — view in
    # tensorboard / xprof)
    profile_dir = get_flag(argv, "-profile_dir")
    if profile_dir:
        jax.profiler.start_trace(profile_dir)
    # -resume ckpt.npz: warm-start from a previous solve's checkpoint
    # (utils.checkpoint; pair with -checkpoint/-checkpoint_every to write)
    x0 = None
    resume = get_flag(argv, "-resume")
    if resume:
        from gcge_tpu.utils.checkpoint import load_checkpoint

        _, x0, nev_prev, _ = load_checkpoint(resume)
        print(f"resuming from {resume} ({nev_prev} converged, "
              f"{x0.shape[1]} vectors)")
    ckpt = get_flag(argv, "-checkpoint")
    if ckpt:
        params = type(params)(**{
            **params.__dict__, "checkpoint_path": ckpt,
            "checkpoint_every": get_flag(argv, "-checkpoint_every", 10, int)})
    result = gcg_solve(a_op, b_op, params, x0=x0, mesh=mesh)
    if profile_dir:
        jax.profiler.stop_trace()
        print(f"profiler trace written to {profile_dir}")
    print(f"\nconverged {result.nev_conv} eigenpairs in {result.num_iter} iterations")
    # -gcge_print_eval N: cap on printed eigenvalues (reference flag,
    # ops_eig_sol_gcg.c usage block); -gcge_print_evec 1 additionally dumps
    # the leading entries of each Ritz vector
    n_print = extras.get("-gcge_print_eval",
                         get_flag(argv, "-gcge_print_eval", 50, int))
    for i, lam in enumerate(result.eval[: min(result.nev_conv or params.nev,
                                              n_print)]):
        print(f"  [{i}] {lam:.14e}")
    if extras.get("-gcge_print_evec", 0):
        ev = np.asarray(result.evec)
        for i in range(min(result.nev_conv or params.nev, n_print)):
            head = " ".join(f"{v:+.6e}" for v in ev[:6, i])
            print(f"  evec[{i}][:6] = {head}")
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
