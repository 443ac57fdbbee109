"""One-call eigensolver frontend.

The reference's MATLAB mex frontend (``/root/reference/app/app_matlab.c:38-223``)
wraps the whole pipeline in a single call: ``(eval, evec, nevConv) =
gcge(A, B, nev, tols, nevMax, blockSize, nevInit, numIterMax, gapMin)`` over a
MATLAB sparse matrix.  :func:`solve` is that entry point for the Python
ecosystem: it accepts scipy sparse / dense numpy / prebuilt operators, picks
the best sparse layout (DIA when the pattern is banded — optionally after RCM
reordering — ELL otherwise), optionally distributes over all devices, runs
GCG and returns ``(eval, evec, nev_conv)`` in the original row order.
"""

from __future__ import annotations

from typing import Any

import numpy as np


def _as_operator(mat, dtype, rcm: bool, perm=None):
    """Coerce a user matrix to a device operator (host-side packing)."""
    import jax.numpy as jnp

    from gcge_tpu.ops.operators import (
        DenseOperator,
        DiagOperator,
        LinearOperator,
        make_operator,
    )

    if mat is None or isinstance(mat, LinearOperator):
        return mat, perm
    try:
        import scipy.sparse as sps

        is_sparse = sps.issparse(mat)
    except Exception:  # pragma: no cover - scipy is baked into the image
        is_sparse = False
    if is_sparse:
        coo = mat.tocoo()
        rows, cols, vals = coo.row, coo.col, coo.data
        if perm is not None:
            inv = np.empty_like(perm)
            inv[perm] = np.arange(len(perm))
            rows, cols = inv[rows], inv[cols]
        return make_operator(rows, cols, vals, coo.shape, dtype=jnp.dtype(dtype)), perm
    arr = np.asarray(mat)
    if arr.ndim == 1:
        d = arr[perm] if perm is not None else arr
        return DiagOperator(jnp.asarray(d, dtype)), perm
    if perm is not None:
        arr = arr[np.ix_(perm, perm)]
    return DenseOperator(jnp.asarray(arr, dtype)), perm


def eigsh(a, k: int = 6, M=None, which: str = "SM", v0=None,
          tol: float = 0.0, maxiter: int | None = None, **kwargs: Any):
    """``scipy.sparse.linalg.eigsh``-compatible front end (smallest pairs).

    Drop-in for SciPy users: ``w, v = gcge_tpu.eigsh(A, k=50, M=B)`` returns
    numpy ``(w, v)`` with ``v`` of shape ``(n, k)``.  Supported ``which``:
    ``'SM'``/``'SA'`` (GCG computes the smallest end of the spectrum — the
    reference library's scope).  ``tol`` maps to the relative-residual
    tolerance (0 = the default 1e-8); extra ``**kwargs`` pass through to
    :func:`solve` (e.g. ``rcm=True``, ``distribute=True``,
    ``multigrid=True``).
    """
    if which not in ("SM", "SA"):
        raise ValueError(
            f"which={which!r} unsupported: GCG targets the smallest "
            "eigenpairs (use which='SM' or 'SA')")
    if v0 is not None and np.asarray(v0).ndim == 1:
        v0 = np.asarray(v0)[:, None]
    ev, evec, nev_conv = solve(
        a, M, nev=k, x0=v0,
        **{**({"tol_rel": tol} if tol else {}),
           **({"max_iter": maxiter} if maxiter else {}),
           **kwargs})
    return np.asarray(ev[:k]), np.asarray(evec)[:, :k]


def solve(
    a,
    b=None,
    nev: int = 30,
    *,
    rcm: bool = False,
    distribute: bool = False,
    multigrid: bool | int = False,
    method: str = "gcg",
    x0=None,
    params=None,
    pas_sweeps: int = 2,
    pas_final_sweeps: int = 16,
    pas_cycles: int = 8,
    pas_composite_rr: bool = False,
    **kwargs: Any,
):
    """Compute the ``nev`` smallest eigenpairs of ``A x = lambda B x``.

    Parameters
    ----------
    a, b : scipy sparse matrix, dense ndarray, 1-D ndarray (diagonal), a
        :class:`~gcge_tpu.ops.operators.LinearOperator`, or ``None`` for B=I.
    nev : number of wanted eigenpairs (mex arg ``nev``).
    rcm : reverse-Cuthill-McKee reorder first (native toolkit) — concentrates
        irregular patterns onto few diagonals so the gather-free DIA kernel
        applies; eigenvectors are returned in the ORIGINAL ordering.
    distribute : ``True``/``'rows'`` — row-shard over all visible devices;
        ``'grid'`` — 2-D rows x cols mesh (basis sharded over BOTH axes, for
        very wide eigenspaces); ``False`` — single device.
    multigrid : build a smoothed-aggregation AMG hierarchy from the sparse
        input and precondition the inner block CG with one Chebyshev-smoothed
        V-cycle (the reference's flag=2 'external solver preconditions BPCG'
        mode, here fully automatic).  Pass an int to cap the level count
        (default 4).  Requires sparse ``a`` (and sparse/None ``b``).
    method : ``'gcg'`` (default) or ``'pas'`` — the multilevel Parallel
        Augmented Subspace solver (needs ``multigrid``; solves on the
        coarsest grid and corrects down the hierarchy).  Composes with
        ``distribute`` (sharded fine level, replicated coarse levels).
    pas_sweeps / pas_final_sweeps / pas_cycles : PAS knobs — correction+RR
        sweeps per intermediate level / on the finest level, and AMG
        V-cycles per correction (reference ``ops_eig_sol_pas.c`` exposes
        the analogous per-level iteration counts).
    params : a prebuilt :class:`~gcge_tpu.solvers.gcg.GCGParams`; otherwise one
        is assembled from ``nev`` and ``**kwargs`` (e.g. ``block_size=...,
        tol_rel=..., max_iter=...`` — the mex argument list).

    Returns ``(eval, evec, nev_conv)`` — numpy eigenvalues (ascending), the
    Ritz vectors as a device array ``(n, nev)``, and the converged count.
    """
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from gcge_tpu.solvers.gcg import GCGParams, gcg_solve

    if params is None:
        params = GCGParams(nev=nev, **kwargs)
    dtype = params.dtype

    perm = None
    if rcm:
        try:
            import scipy.sparse as sps
            from scipy.sparse.csgraph import reverse_cuthill_mckee

            if sps.issparse(a):
                perm = np.asarray(reverse_cuthill_mckee(a.tocsr(), symmetric_mode=True))
        except Exception:
            perm = None

    a_op, perm = _as_operator(a, dtype, rcm, perm)
    b_op, _ = _as_operator(b, dtype, rcm, perm)

    # ---- optional AMG hierarchy from the sparse input --------------------
    hier = None
    if multigrid or method == "pas":
        import scipy.sparse as sps

        assert sps.issparse(a), "multigrid/pas need a scipy-sparse A"
        max_levels = multigrid if isinstance(multigrid, int) and \
            multigrid > 1 else 4
        coo = a.tocoo()
        rows_h, cols_h, vals_h = coo.row, coo.col, coo.data
        if perm is not None:
            inv = np.empty_like(perm)
            inv[perm] = np.arange(len(perm))
            rows_h, cols_h = inv[rows_h], inv[cols_h]
        b_vals_h = None
        if b is not None and sps.issparse(b):
            # build_hierarchy takes B on A's sparsity pattern; project the
            # B entries onto it (entries of B outside A's pattern would be
            # dropped — reject that instead of silently mis-coarsening)
            bcsr = sps.csr_matrix(b)
            pattern = sps.csr_matrix(
                (np.ones(coo.nnz), (rows_h, cols_h)), shape=coo.shape)
            outside = (abs(bcsr) - abs(bcsr).multiply(pattern)).count_nonzero()
            assert outside == 0, (
                "multigrid/pas: B has nonzeros outside A's pattern")
            b_on_a = np.asarray(
                bcsr[rows_h, cols_h]).ravel()
            b_vals_h = b_on_a
        elif b is not None and method == "pas":
            raise ValueError("method='pas' with B needs a scipy-sparse B "
                             "on A's sparsity pattern")
        from gcge_tpu.solvers.multigrid import (bamg_preconditioner,
                                                build_hierarchy)

        hier = build_hierarchy(rows_h, cols_h, vals_h, coo.shape[0],
                               b_vals=b_vals_h, max_levels=max_levels)
        if method != "pas" and not distribute:
            params = type(params)(**{
                **params.__dict__,
                "linear_precond": bamg_preconditioner(hier)})

    mesh = None
    if distribute:
        from gcge_tpu.parallel import (grid_mesh, pad_problem, row_mesh,
                                       shard_operator)

        n_dev = len(jax.devices())
        if n_dev > 1:
            if distribute == "grid" and n_dev % 2 == 0 and n_dev >= 4:
                mesh = grid_mesh(n_dev // 2, 2)
                n_rows_dev = n_dev // 2
            else:
                mesh = row_mesh(n_dev)
                n_rows_dev = n_dev
            a_op, b_op, _ = pad_problem(a_op, b_op, n_rows_dev)
            a_op = shard_operator(a_op, mesh)
            b_op = shard_operator(b_op, mesh) if b_op is not None else None
            if hier is not None:
                from gcge_tpu.parallel.dist_mg import shard_hierarchy
                from gcge_tpu.solvers.multigrid import bamg_preconditioner

                if hier.levels[0].a_op.shape[0] % n_rows_dev == 0:
                    hier = shard_hierarchy(hier, mesh)
                if method != "pas":
                    params = type(params)(**{
                        **params.__dict__,
                        "linear_precond": bamg_preconditioner(hier)})

    if method == "pas":
        from gcge_tpu.solvers.pas import pas_solve

        res = pas_solve(hier, params.nev, tol_rel=params.tol_rel,
                        verbose=params.verbose,
                        sweeps_per_level=pas_sweeps,
                        final_sweeps=pas_final_sweeps,
                        bamg_cycles=pas_cycles,
                        composite_rr=pas_composite_rr)
    else:
        res = gcg_solve(a_op, b_op, params, x0=x0, mesh=mesh)
    evec = res.evec
    n = a.shape[0] if hasattr(a, "shape") else evec.shape[0]
    evec = evec[:n]
    if perm is not None:
        inv = jnp.asarray(perm)
        evec = jnp.zeros_like(evec).at[inv].set(evec)
    return res.eval[: params.resolved(n).nev], evec, res.nev_conv
