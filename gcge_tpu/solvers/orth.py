"""Block B-orthonormalization with rank deflation — static shapes.

The reference implements three drivers over vtable ops
(``/root/reference/src/ops_orth.c``): column-wise modified Gram-Schmidt
(``OrthSelf``/``ModifiedGramSchmidt``), a recursive binary split (``OrthBinary``)
and an eigendecomposition variant (``OrthSelfEVP``: Gram matrix -> ``dsyev`` ->
scale by ``1/sqrt(lambda)``, drop ``lambda ~ 0`` columns).

The EVP family is the default here — it is all GEMM plus one tiny ``eigh``
— so :func:`orth_block` is the primary kernel.  Deflation semantics
are preserved without shrinking arrays: the returned multivector has its
``rank`` valid columns compacted at the front (descending Gram eigenvalue
order) and zeros behind, with ``rank`` returned as a traced scalar.

``orth_against`` is the "project out X0" loop of ``ModifiedGramSchmidt``
(``ops_orth.c:235-268``); :func:`mgs_orth` is a literal column-wise MGS kept
for cross-checking the EVP kernel in tests.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gcge_tpu.ops.multivec import col_dots, gram


def _rel_floor(dtype) -> float:
    """Gram-eigenvalue relative deflation floor.

    Eigenvalues below the Gram computation's noise floor are rounding
    artifacts; normalizing them by ``1/sqrt(w)`` injects garbage directions
    into the basis.  64*eps sits above the Gram's rounding noise (the
    reference uses 20*eps/50*eps tolerances, ``ops_orth.c:401-404``)."""
    return 64.0 * float(jnp.finfo(dtype).eps)


def orth_against(x, q, b_matvec=None, passes: int = 2,
                 precision: str = "f64"):
    """Remove the B-projection of ``x`` onto the B-orthonormal block ``q``.

    ``x <- x - q (q^T B x)``, repeated ``passes`` times (classical two-pass
    re-orthogonalization; the reference re-orths up to ``1+max_reorth`` times
    with an early exit on the coefficient norm, ``ops_orth.c:235-268``).
    Invalid (masked) columns of either block must be zero — zero columns
    produce zero coefficients and are no-ops.

    ``precision='mixed'`` runs the two GEMMs of each pass (coefficient Gram
    and projection update) in f32, at full f32 precision (never TF32).
    ONLY valid for MIDDLE passes
    sandwiched between full-f64 passes, because f32 has two hard floors
    (both measured as end-to-end convergence stalls when violated):

    * it must never remove the bulk (first pass): GCG's auto-shifted W
      carries a span(q) component up to ~1e8x the informative correction,
      and f32 arithmetic noise ``eps_f32 * ||x||`` buries the correction;
    * it can never be the LAST pass: an f32 inner product of unit-norm
      columns has ~1e-7 ABSOLUTE error regardless of the true coefficient,
      so a mixed pass *injects* ~1e-7 span(q) leakage that only a
      subsequent f64 pass can remove.

    A mixed middle pass reduces the within-block rescaling's re-amplified
    leakage (up to ~1e-2) to the 1e-7 floor — enough for the next
    within-block Gram — at ~5% of the f64 cost; the trailing f64 pass then
    restores the ~1e-15 final floor exactly as in the all-f64 path.
    """
    mixed = precision == "mixed"
    q32 = q.astype(jnp.float32) if mixed else None
    hi = jax.lax.Precision.HIGHEST
    for _ in range(passes):
        bx = x if b_matvec is None else b_matvec(x)
        if mixed:
            coef32 = jnp.matmul(q32.T, bx.astype(jnp.float32), precision=hi)
            x = x - jnp.matmul(q32, coef32, precision=hi).astype(x.dtype)
        else:
            coef = gram(q, bx)
            x = x - q @ coef
    return x


def orth_block(
    x,
    b_matvec=None,
    zero_tol: float = 1e-13,
    passes: int = 2,
    ref_scale2=None,
):
    """B-orthonormalize the columns of ``x`` with rank deflation.

    Returns ``(x_orth, rank)``: the first ``rank`` columns form a B-orthonormal
    basis of ``range(x)``; trailing columns are exactly zero.  ``rank`` is a
    traced scalar (int32).

    Method (reference ``OrthSelfEVP``, ``ops_orth.c:122-201``): per pass,
    ``G = x^T B x`` (one fused GEMM), ``w, u = eigh(G)``; columns are
    recombined as ``x u diag(1/sqrt(w))`` in *descending* eigenvalue order so
    numerically dependent directions compact to the back as zeros.  Two passes
    give CholQR2-level orthogonality.

    Deflation threshold: a column is dependent when its projected *norm*
    ``sqrt(w)`` falls below ``zero_tol`` relative to the entry scale
    ``sqrt(ref_scale2)`` — i.e. ``w <= zero_tol^2 * ref_scale2`` — matching the
    reference's norm-based criterion (``OrthSelf``, ``ops_orth.c:63-74``); an
    absolute threshold on ``w`` itself would deflate the small-but-genuine
    inverse-power corrections GCG relies on late in convergence.
    ``ref_scale2`` defaults to the largest Gram eigenvalue of the first pass.
    """
    m = x.shape[1]
    rank = jnp.int32(m)
    floor = _rel_floor(x.dtype)
    for i in range(passes):
        bx = x if b_matvec is None else b_matvec(x)
        g = gram(x, bx)
        g = 0.5 * (g + g.T)
        from gcge_tpu.ops.eighs import F32_WARM_MIN_M, eigh_newton, safe_eigh

        if m >= F32_WARM_MIN_M:
            # wide blocks (huge-nev InitializeX, PAS spans) take the
            # f32-warm multi-pass Newton eigh (ops.eighs.eigh_newton)
            w, u = eigh_newton(g)
        else:
            w, u = safe_eigh(g)   # NaN-guarded: rank-deficient Grams can NaN
        w = w[::-1]
        u = u[:, ::-1]
        w_max = jnp.maximum(w[0], jnp.asarray(1e-300, x.dtype))
        if ref_scale2 is None and i == 0:
            ref_scale2 = w_max
        thresh = (zero_tol * zero_tol) * ref_scale2 if i == 0 else \
            jnp.asarray(zero_tol, x.dtype)
        # Gram eigenvalues below the Gram/eigh noise floor are
        # indistinguishable from rounding noise: normalizing them by
        # 1/sqrt(w) would inject garbage directions into the basis (GCG's W
        # block near convergence is exactly this regime).  The relative floor
        # also caps the accepted sub-block's condition number, which is what
        # makes the second EVP pass reach floor-level orthogonality (CholQR2
        # analysis).
        thresh = jnp.maximum(thresh, floor * w_max)
        valid = w > thresh
        scale = jnp.where(valid, jax.lax.rsqrt(jnp.where(valid, w, 1.0)), 0.0)
        x = x @ (u * scale[None, :])
        rank = jnp.minimum(rank, jnp.sum(valid).astype(jnp.int32))
    return _ns_polish(x, b_matvec), rank


def _ns_polish(x, b_matvec=None):
    """One Newton-Schulz step ``x <- x (3I - x^T B x)/2``.

    The EVP recombination above inherits the eigh backtransform error,
    leaving ``x^T B x = I + d``.  One NS step — a single accurate Gram plus
    one tall GEMM — contracts that quadratically to ``O(||d||^2)``.
    Deflated (zero) columns have zero Gram rows/columns, so their NS update
    is ``1.5 * 0 = 0``: compaction is preserved exactly."""
    bx = x if b_matvec is None else b_matvec(x)
    g = gram(x, bx)
    m = x.shape[1]
    return x @ (1.5 * jnp.eye(m, dtype=x.dtype) - 0.5 * g)


def orth_within(x, b_matvec=None, zero_tol: float = 1e-13, passes: int = 2,
                ref_scale2=None, method: str = "evp"):
    """In-block B-orthonormalization dispatcher.

    ``method`` mirrors the reference's orth-method selection
    (``ops_orth.h:36-41`` / ``-gcge_*_orth_method`` flags): ``'evp'`` —
    :func:`orth_block` (the default, Gram-eigh recombination);
    ``'bgs'`` — :func:`bgs_orth` (binary split); ``'mgs'`` —
    :func:`mgs_orth` (column-wise modified Gram-Schmidt; O(m^2) traced ops,
    use only for narrow blocks / cross-checks).
    """
    if method == "evp":
        return orth_block(x, b_matvec, zero_tol=zero_tol, passes=passes,
                          ref_scale2=ref_scale2)
    if method == "bgs":
        x, rank = bgs_orth(x, b_matvec, zero_tol=zero_tol, passes=passes,
                           ref_scale2=ref_scale2)
    elif method == "mgs":
        x, rank = mgs_orth(x, b_matvec, zero_tol=zero_tol * zero_tol)
    else:
        raise ValueError(f"unknown orth method {method!r}")
    # bgs/mgs zero dependent columns IN PLACE (like the reference's column
    # swap-to-back, ops_orth.c:63-74); GCG's count-based masks assume the
    # valid columns are COMPACTED at the front (the EVP kernel's layout), so
    # stable-sort the exact-zero columns to the back
    nonzero = col_dots(x, x) > 0
    order = jnp.argsort(~nonzero, stable=True)
    return jnp.take(x, order, axis=1), rank


def orth_block_against(
    x,
    q,
    b_matvec=None,
    zero_tol: float = 1e-13,
    passes: int = 2,
    ref_scale2=None,
    method: str = "evp",
    precision: str = "f64",
):
    """Full ``MultiVecOrth`` semantics: orth ``x`` against ``q`` then within.

    The against/within alternation is interleaved ``passes`` times because an
    internal recombination can re-grow components along ``q`` at roundoff
    scale; this mirrors the reference's outer re-orth loop.  The deflation
    scale is the entry-time column norm (before projection), so a direction
    that is small *because most of x lies in span(q)* — exactly GCG's W late
    in convergence — survives, while eps-level dependency is dropped.

    ``precision`` ('f64' or 'mixed') controls the middle against-block
    projections (see :func:`orth_against`); the first and the last
    projection and all within-block work run f64.
    """
    if ref_scale2 is None:
        bx = x if b_matvec is None else b_matvec(x)
        d = col_dots(x, bx)
        ref_scale2 = jnp.maximum(jnp.max(d), jnp.asarray(1e-300, x.dtype))
    rank = jnp.int32(x.shape[1])
    for i in range(passes):
        # the FIRST projection removes the bulk — its coefficients can be
        # ~1e8x the informative remainder (GCG's auto-shifted W), so it must
        # run at full accuracy; later passes handle ~eps_f32-scale
        # coefficients where the f32 path's RELATIVE error suffices
        x = orth_against(x, q, b_matvec, passes=1,
                         precision="f64" if i == 0 else precision)
        x, r = orth_within(
            x, b_matvec, zero_tol=zero_tol, passes=1,
            ref_scale2=ref_scale2 if i == 0 else None, method=method,
        )
        rank = jnp.minimum(rank, r)
    # one final PROJECTION pass: the last within-block recombination
    # normalizes near-deflation-floor directions by up to 1/sqrt(w_min),
    # re-amplifying their residual span(q) leakage by the same factor
    # (observed as ~1e-7 basis-orthonormality decay and spurious
    # eigenvalues below lambda_min over long huge-nev runs).  A projection
    # leaves within-block orthonormality intact to (leakage)^2.  This pass
    # must be f64: it is what takes the leakage (including the ~1e-7
    # absolute noise a mixed middle pass injects) down to the accurate-Gram
    # floor (see orth_against).
    return orth_against(x, q, b_matvec, passes=1, precision="f64"), rank


def bgs_orth(
    x,
    b_matvec=None,
    zero_tol: float = 1e-13,
    passes: int = 2,
    leaf: int = 16,
    ref_scale2=None,
):
    """Binary-split B-orthonormalization (reference ``BinaryGramSchmidt`` /
    ``OrthBinary``, ``ops_orth.c:415-622``): recursively orthonormalize the
    left half, project it out of the right half, recurse right.

    The EVP kernel (:func:`orth_block`) is already one fused GEMM +
    small eigh, so the binary split is not needed for speed at GCG block
    sizes; it exists for parity and for very wide blocks (hundreds of
    columns) where the ``m x m`` Gram eigh starts to dominate — the split
    caps the eigh size at ``leaf`` while keeping all projections as large
    GEMMs (the same trade the reference makes by picking 'E'VP under 16
    vectors and blocked MGS above, ``ops_orth.c:577-590``).

    Deflation: dependent columns are zeroed *in place* (not compacted across
    halves); the returned rank counts surviving columns.
    """
    if ref_scale2 is None:
        # deflation is judged against the ENTRY column scale, as in
        # orth_block_against: a half-block that projects to roundoff noise
        # must deflate, not re-normalize against its own noise scale
        bx = x if b_matvec is None else b_matvec(x)
        d = col_dots(x, bx)
        ref_scale2 = jnp.maximum(jnp.max(d), jnp.asarray(1e-30, x.dtype))
    m = x.shape[1]
    if m <= leaf:
        return orth_block(x, b_matvec, zero_tol=zero_tol, passes=passes,
                          ref_scale2=ref_scale2)
    half = m // 2
    left, lrank = bgs_orth(x[:, :half], b_matvec, zero_tol, passes, leaf,
                           ref_scale2)
    right = orth_against(x[:, half:], left, b_matvec, passes=passes)
    right, rrank = bgs_orth(right, b_matvec, zero_tol, passes, leaf,
                            ref_scale2)
    # one more projection pass: recombinations inside the right-half orth can
    # re-grow left components at roundoff scale (the reference's outer
    # re-orth loop, ops_orth.c:518-622)
    right = orth_against(right, left, b_matvec, passes=1)
    right = _ns_polish(right, b_matvec)
    return jnp.concatenate([left, right], axis=1), lrank + rrank


def mgs_orth(x, b_matvec=None, zero_tol: float = 1e-14, reorth: int = 1):
    """Column-wise modified Gram-Schmidt with deflation (test oracle).

    A literal static-shape transcription of ``OrthSelf``
    (``ops_orth.c:45-118``): dependent columns are zeroed in place (instead of
    being swapped to the back) and the count of surviving columns is returned.
    Quadratic in the column count — use :func:`orth_block` in production.
    """
    m = x.shape[1]
    cols = []
    rank = jnp.int32(0)
    for k in range(m):
        v = x[:, k]
        for _ in range(1 + reorth):
            for qcol in cols:
                bv = v if b_matvec is None else b_matvec(v[:, None])[:, 0]
                v = v - qcol * (qcol @ bv)
        bv = v if b_matvec is None else b_matvec(v[:, None])[:, 0]
        nrm2 = v @ bv
        ok = nrm2 > zero_tol
        inv = jnp.where(ok, jax.lax.rsqrt(jnp.where(ok, nrm2, 1.0)), 0.0)
        v = v * inv
        cols.append(v)
        rank = rank + ok.astype(jnp.int32)
    return jnp.stack(cols, axis=1), rank
