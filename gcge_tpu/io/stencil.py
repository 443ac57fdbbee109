"""The 3D 27-point Laplacian and its exact spectrum.

``A = 27 I - J (x) J (x) J`` with ``J = tridiag(1, 1, 1)`` of order ``nx``:
26 on the diagonal and -1 for each of the 26 grid neighbours (Dirichlet
boundary).  Its eigenvalues are known in closed form,

    lambda = 27 - prod_{i=1..3} (1 + 2 cos(k_i pi / (nx + 1))),
    k_i = 1..nx,

which makes it an exact oracle at any size.  The reference's benchmark
family (reference ``test/submit.sh:9-15``) runs operators of this
row density; ``nx = 54`` gives n = 157,464 and nnz = 4,096,000.
"""

from __future__ import annotations

import numpy as np


def laplacian_27pt(nx: int):
    """COO triplets ``(rows, cols, vals, n)`` of the 27-point Laplacian."""
    n = nx ** 3
    idx = np.arange(n)
    i, j, k = idx // (nx * nx), (idx // nx) % nx, idx % nx
    rows, cols, vals = [], [], []
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            for dk in (-1, 0, 1):
                ii, jj, kk = i + di, j + dj, k + dk
                ok = ((ii >= 0) & (ii < nx) & (jj >= 0) & (jj < nx)
                      & (kk >= 0) & (kk < nx))
                w = 26.0 if (di == 0 and dj == 0 and dk == 0) else -1.0
                rows.append(idx[ok])
                cols.append((ii * nx * nx + jj * nx + kk)[ok])
                vals.append(np.full(ok.sum(), w))
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), n


def laplacian_27pt_eigenvalues(nx: int, count: int) -> np.ndarray:
    """The ``count`` smallest eigenvalues of :func:`laplacian_27pt`, ascending."""
    mu = 1.0 + 2.0 * np.cos(np.arange(1, nx + 1) * np.pi / (nx + 1))
    prod = (mu[:, None, None] * mu[None, :, None] * mu[None, None, :]).ravel()
    lam = 27.0 - prod
    count = min(count, lam.size)
    return np.sort(np.partition(lam, count - 1)[:count])
