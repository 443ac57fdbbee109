"""Command-line flag surface, compatible with the reference's ``-gcge_*``
namespace.

The reference parses flags with a linear argv scan
(``DefaultGetOptionFromCommandLine``, ``/root/reference/src/ops_multi_vec.c:
58-95``) into the ``GCGSolver`` struct
(``EigenSolverSetParametersFromCommandLine_GCG``,
``/root/reference/src/ops_eig_sol_gcg.c:1737-1807``), plus driver-level flags
``-nevConv -nevMax -blockSize -nevInit``
(``test/test_eig_sol_gcg.c:40-46``).  This module maps the same names onto
:class:`~gcge_tpu.solvers.gcg.GCGParams`; flags that configure reference
internals with no analogue here (orthogonalization block sizes and
re-orth counts) are accepted and recorded but have no effect,
so existing scripts keep running.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from gcge_tpu.solvers.gcg import GCGParams

# -flag -> (GCGParams field, type)
_FLAG_MAP = {
    "-nevConv": ("nev", int),
    "-nevMax": ("nev_max", int),
    "-blockSize": ("block_size", int),
    "-nevInit": ("nev_init", int),
    "-gcge_min_gap": ("gap_min", float),
    "-gcge_max_multi": ("multi_max", int),
    "-gcge_max_niter": ("max_iter", int),
    "-gcge_abs_tol": ("tol_abs", float),
    "-gcge_rel_tol": ("tol_rel", float),
    "-gcge_compW_cg_max_iter": ("cg_max_iter", int),
    "-gcge_compW_cg_rate": ("cg_rate", float),
    "-gcge_compW_cg_tol": ("cg_tol", float),
    "-gcge_compW_cg_tol_type": ("cg_tol_type", str),
    "-gcge_compW_cg_auto_shift": ("cg_auto_shift", lambda v: bool(int(v))),
    "-gcge_compW_cg_shift": ("cg_shift", float),
    "-gcge_print_conv": ("verbose", int),
    "-gcge_compW_cg_order": ("cg_order", int),
    "-gcge_check_conv_max_num": ("check_max", int),
    "-profile_dir": ("profile_dir", str),
    "-fuse": ("fuse", int),
    "-fuse_hotswap": ("fuse_hotswap", str),
}

# accepted for compatibility; recorded in `extras`, no effect here
_COMPAT_FLAGS = {
    "-gcge_given_nevec": int,
    "-gcge_user_defined_multi_lin_sol": int,
    "-gcge_initX_orth_method": str,
    "-gcge_initX_orth_block_size": int,
    "-gcge_initX_orth_max_reorth": int,
    "-gcge_initX_orth_zero_tol": float,
    "-gcge_compP_orth_method": str,
    "-gcge_compP_orth_block_size": int,
    "-gcge_compP_orth_max_reorth": int,
    "-gcge_compP_orth_zero_tol": float,
    "-gcge_compW_orth_method": str,
    "-gcge_compW_orth_block_size": int,
    "-gcge_compW_orth_max_reorth": int,
    "-gcge_compW_orth_zero_tol": float,
    "-gcge_compRR_min_num": int,
    "-gcge_compRR_min_gap": float,
    "-gcge_compRR_tol": float,
    "-gcge_print_usage": int,
    "-gcge_print_orth_zero": int,
    "-gcge_print_split": int,
    "-gcge_print_eval": int,
    "-gcge_print_evec": int,
    "-gcge_print_time": int,
}

_ORTH_TOL_FLAGS = {
    "-gcge_initX_orth_zero_tol",
    "-gcge_compP_orth_zero_tol",
    "-gcge_compW_orth_zero_tol",
}


def params_from_args(
    argv: Sequence[str], base: GCGParams | None = None
) -> tuple[GCGParams, dict]:
    """Build GCGParams from argv; returns ``(params, extras)``.

    ``extras`` holds compatibility flags that were recognized but have no
    direct field (their reference semantics are either folded into the single
    orthogonalizer or obsolete under XLA).
    """
    fields = dict(dataclasses.asdict(base or GCGParams()))
    extras: dict = {}
    i = 0
    argv = list(argv)
    while i < len(argv):
        tok = argv[i]
        if tok in _FLAG_MAP and i + 1 < len(argv):
            name, conv = _FLAG_MAP[tok]
            fields[name] = conv(argv[i + 1])
            i += 2
        elif tok in _COMPAT_FLAGS and i + 1 < len(argv):
            extras[tok] = _COMPAT_FLAGS[tok](argv[i + 1])
            if tok in _ORTH_TOL_FLAGS:
                fields["orth_zero_tol"] = float(argv[i + 1])
            if tok.endswith("_orth_method"):
                meth = str(argv[i + 1]).lower()
                if "bgs" in meth or meth == "b":
                    fields["orth_method"] = "bgs"
                elif "mgs" in meth or meth == "m":
                    fields["orth_method"] = "mgs"
                # 'evp'/anything else: the default EVP kernel
            i += 2
        else:
            i += 1
    return GCGParams(**fields), extras


def print_usage(printer=print):
    """Usage block listing the supported flag surface (the analogue of
    ``ops_eig_sol_gcg.c:1811-1860``)."""
    d = GCGParams()
    printer("Usage: <driver> [<options>]")
    printer("-" * 78)
    printer(f" -nevConv   <i>: number of wanted eigenpairs      (default {d.nev})")
    printer(f" -nevMax    <i>: working eigenspace size          (default 2*nevConv)")
    printer(f" -blockSize <i>: block size                       (default nevConv/5)")
    printer(f" -nevInit   <i>: initial X width                  (default nevMax)")
    printer(f" -gcge_max_niter <i>: max GCG iterations          (default {d.max_iter})")
    printer(f" -gcge_abs_tol   <f>: absolute residual tolerance (default {d.tol_abs})")
    printer(f" -gcge_rel_tol   <f>: relative residual tolerance (default {d.tol_rel})")
    printer(f" -gcge_min_gap   <f>: multiplicity cluster gap    (default {d.gap_min})")
    printer(f" -gcge_max_multi <i>: max multiplicity (backoff cap, default blockSize)")
    printer(f" -gcge_compW_cg_max_iter <i>: inner CG iterations (default {d.cg_max_iter})")
    printer(f" -gcge_compW_cg_rate <f>: inner CG reduction rate (default {d.cg_rate})")
    printer(f" -gcge_compW_cg_tol  <f>: inner CG tolerance      (default {d.cg_tol})")
    printer(f" -gcge_compW_cg_tol_type <s>: abs|rel|user        (default {d.cg_tol_type})")
    printer(f" -gcge_compW_cg_auto_shift <i>: auto sigma        (default {int(d.cg_auto_shift)})")
    printer(f" -gcge_compW_cg_shift <f>: manual sigma           (default {d.cg_shift})")
    printer(" (reference -gcge_*_orth_* and -gcge_compRR_* flags are accepted")
    printer("  for compatibility; the orth method strings select evp/bgs/mgs,")
    printer("  the rest have no effect: the eigh is replicated)")


def main(argv=None):
    """Console entry point (``gcge-solve``): delegates to the full driver in
    ``examples/gcge_solve.py`` semantics — loads/assembles a matrix, picks
    the sparse layout, runs GCG, prints eigenvalues.  The flag surface is the
    reference's ``-gcge_*`` namespace plus driver flags (see
    :func:`print_usage` and the examples docstring)."""
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "..", "examples",
                        "gcge_solve.py")
    path = os.path.abspath(path)
    if os.path.exists(path):
        spec = importlib.util.spec_from_file_location("gcge_solve_cli", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.main(argv)
    # installed without the examples tree: minimal in-package driver
    import numpy as np

    from gcge_tpu.io.fem import cube_fem_laplacian
    from gcge_tpu.ops.operators import make_operator
    from gcge_tpu.solvers.gcg import gcg_solve

    nx = int(argv[argv.index("-fem_nx") + 1]) if "-fem_nx" in argv else 12
    rows, cols, a_vals, b_vals, n = cube_fem_laplacian(nx)
    params, _ = params_from_args(argv)
    res = gcg_solve(make_operator(rows, cols, a_vals, (n, n)),
                    make_operator(rows, cols, b_vals, (n, n)), params)
    for i, lam in enumerate(res.eval[: res.nev_conv or params.nev]):
        print(f"  [{i}] {lam:.14e}")
    return res
