"""ctypes bindings for the native matrix toolkit (native/matpack.cpp).

The native layer plays the role the reference delegates to PETSc/MKL/PHG for
host-side matrix work: fast file ingestion, RCM bandwidth reduction (which
unlocks the gather-free DIA SpMM on irregular matrices) and ELL packing.
The library is built on demand with the repo Makefile; every entry point has a
pure-numpy fallback so the framework works without a C++ toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libmatpack.so"))
_lib = None


def _load(build: bool = True):
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH) and build:
        try:
            subprocess.run(
                ["make", "-s", "libmatpack.so"],
                cwd=os.path.abspath(_NATIVE_DIR),
                check=True,
                capture_output=True,
            )
        except Exception:
            return None
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    i64 = ctypes.c_int64
    lib.mm_stat.restype = ctypes.c_int
    lib.mm_stat.argtypes = [ctypes.c_char_p] + [ctypes.POINTER(i64)] * 3 + \
        [ctypes.POINTER(ctypes.c_int32)] * 2
    lib.mm_read.restype = i64
    lib.mm_read.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.float64), i64,
    ]
    lib.rcm_order.restype = ctypes.c_int
    lib.rcm_order.argtypes = [
        i64, i64,
        np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64),
    ]
    lib.bandwidth.restype = i64
    lib.bandwidth.argtypes = [
        i64, np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.int64)
    ]
    lib.n_diagonals.restype = i64
    lib.n_diagonals.argtypes = lib.bandwidth.argtypes
    lib.ell_width.restype = i64
    lib.ell_width.argtypes = [i64, i64, np.ctypeslib.ndpointer(np.int64)]
    lib.coo_to_ell.restype = ctypes.c_int
    lib.coo_to_ell.argtypes = [
        i64, i64,
        np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.float64), i64,
        np.ctypeslib.ndpointer(np.float64), np.ctypeslib.ndpointer(np.int32),
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def load_matrix_market_native(path: str):
    """Native MatrixMarket reader; falls back to the Python loader."""
    lib = _load()
    if lib is None or str(path).endswith(".gz"):
        from gcge_tpu.io.loaders import load_matrix_market

        return load_matrix_market(path)
    nr = ctypes.c_int64()
    nc = ctypes.c_int64()
    nnz = ctypes.c_int64()
    sym = ctypes.c_int32()
    pat = ctypes.c_int32()
    rc = lib.mm_stat(path.encode(), ctypes.byref(nr), ctypes.byref(nc),
                     ctypes.byref(nnz), ctypes.byref(sym), ctypes.byref(pat))
    if rc != 0:
        raise IOError(f"mm_stat failed ({rc}) for {path}")
    cap = 2 * nnz.value
    rows = np.empty(cap, np.int64)
    cols = np.empty(cap, np.int64)
    vals = np.empty(cap, np.float64)
    k = lib.mm_read(path.encode(), rows, cols, vals, cap)
    if k < 0:
        raise IOError(f"mm_read failed ({k}) for {path}")
    return rows[:k], cols[:k], vals[:k], (nr.value, nc.value)


def rcm_permutation(rows, cols, n: int) -> np.ndarray:
    """Reverse Cuthill-McKee ordering: returns perm with perm[new] = old."""
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    lib = _load()
    if lib is not None:
        perm = np.empty(n, np.int64)
        rc = lib.rcm_order(n, len(rows), rows, cols, perm)
        if rc == 0:
            return perm
    # scipy fallback
    import scipy.sparse as sps
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    a = sps.coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n)).tocsr()
    return np.asarray(reverse_cuthill_mckee(a, symmetric_mode=True), np.int64)


def apply_permutation(rows, cols, vals, perm):
    """Symmetric permutation: A' = P A P^T with P the RCM ordering."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv[np.asarray(rows)], inv[np.asarray(cols)], np.asarray(vals)


def structure_stats(rows, cols, n: int) -> dict:
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    lib = _load()
    if lib is not None:
        return {
            "bandwidth": int(lib.bandwidth(len(rows), rows, cols)),
            "n_diagonals": int(lib.n_diagonals(len(rows), rows, cols)),
            "ell_width": int(lib.ell_width(n, len(rows), rows)),
        }
    offs = cols - rows
    return {
        "bandwidth": int(np.abs(offs).max()) if len(offs) else 0,
        "n_diagonals": int(len(np.unique(offs))),
        "ell_width": int(np.bincount(rows, minlength=n).max()),
    }
