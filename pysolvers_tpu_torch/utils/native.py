"""ctypes bindings for the native setup library (native/pst_native.cpp).

Copied from ``pysolvers_tpu/utils/native.py``, code unchanged (importing that
package imports jax).  Both packages bind the SAME ``native/libpst_native.so``.

Auto-builds with g++ on first use if the shared object is missing; every
entry point has a pure-numpy fallback in the Python layer, so the framework
degrades gracefully on hosts without a toolchain (``PST_NO_NATIVE=1``
forces the fallback).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")


def _build() -> Optional[str]:
    so = os.path.join(_NATIVE_DIR, "libpst_native.so")
    src = os.path.join(_NATIVE_DIR, "pst_native.cpp")
    if os.path.exists(so) and (not os.path.exists(src)
                               or os.path.getmtime(so) >= os.path.getmtime(src)):
        return so
    if not os.path.exists(src):
        return None
    try:
        # compile to a temp name + atomic rename: concurrent builds
        # (pytest-xdist, shared storage) must never interleave writes
        # into the final .so — a corrupt file with a fresh mtime would
        # suppress every future rebuild
        tmp = f"{so}.build.{os.getpid()}"
        subprocess.run(["g++", "-O3", "-std=c++17", "-pthread",
                        "-shared", "-fPIC",
                        "-o", tmp, src], check=True, capture_output=True)
        os.replace(tmp, so)
        return so
    except Exception:
        return os.path.exists(so) and so or None


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("PST_NO_NATIVE"):
        return None
    so = _build()
    if not so:
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None

    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")

    try:
        lib.csr_result_new.restype = ctypes.c_void_p
        lib.csr_result_free.argtypes = [ctypes.c_void_p]
        lib.csr_result_nnz.argtypes = [ctypes.c_void_p]
        lib.csr_result_nnz.restype = ctypes.c_int64
        lib.csr_result_nrows.argtypes = [ctypes.c_void_p]
        lib.csr_result_nrows.restype = ctypes.c_int64
        lib.csr_result_copy.argtypes = [ctypes.c_void_p, i64p, i32p, f64p]

        lib.spgemm.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                           i64p, i32p, f64p, i64p, i32p, f64p,
                           ctypes.c_void_p]
        lib.ilut.argtypes = [ctypes.c_int64, i64p, i32p, f64p, ctypes.c_double,
                         ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p]
        lib.levelize.argtypes = [ctypes.c_int64, i64p, i32p, ctypes.c_int32,
                             i64p]
        lib.aggregate.argtypes = [ctypes.c_int64, i64p, i32p, i64p]
        lib.aggregate.restype = ctypes.c_int64
        lib.rcm.argtypes = [ctypes.c_int64, i64p, i32p, i64p]
        try:                      # tolerate a stale .so predating sym_rcm
            lib.sym_rcm.argtypes = [ctypes.c_int64, i64p, i32p, i64p]
        except AttributeError:
            pass
        lib.mtx_read.argtypes = [ctypes.c_char_p, i64p, i64p, f64p,
                                 ctypes.c_int64, i64p,
                                 ctypes.POINTER(ctypes.c_int32)]
        lib.mtx_read.restype = ctypes.c_int64
        try:                      # tolerate a stale .so predating it
            lib.csr_matvec.argtypes = [ctypes.c_int64, i64p, i32p, f64p,
                                       f64p, f64p]
        except AttributeError:
            pass
        try:                      # tolerate a stale .so predating it
            lib.csr_permute_plan.argtypes = [ctypes.c_int64, i64p, i32p,
                                             i64p, i64p, i32p, i64p]
        except AttributeError:
            pass
    except AttributeError:
        # stale .so missing a required symbol (e.g. a failed rebuild
        # left the old library): degrade to the numpy fallbacks the
        # callers expect on None, don't crash setup
        return None
    _LIB = lib
    return _LIB


def _copy_out(lib, handle) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    nnz = lib.csr_result_nnz(handle)
    n = lib.csr_result_nrows(handle)
    indptr = np.empty(n + 1, dtype=np.int64)
    indices = np.empty(nnz, dtype=np.int32)
    data = np.empty(nnz, dtype=np.float64)
    lib.csr_result_copy(handle, indptr, indices, data)
    return indptr, indices, data


def spgemm(a_indptr, a_indices, a_data, b_indptr, b_indices, b_data,
           shape_a, shape_b):
    """C = A @ B via native Gustavson.  Returns (indptr, indices, data) or
    None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    h = lib.csr_result_new()
    try:
        lib.spgemm(shape_a[0], shape_a[1], shape_b[1],
                   np.ascontiguousarray(a_indptr, np.int64),
                   np.ascontiguousarray(a_indices, np.int32),
                   np.ascontiguousarray(a_data, np.float64),
                   np.ascontiguousarray(b_indptr, np.int64),
                   np.ascontiguousarray(b_indices, np.int32),
                   np.ascontiguousarray(b_data, np.float64), h)
        return _copy_out(lib, h)
    finally:
        lib.csr_result_free(h)


def ilut(indptr, indices, data, n, drop_tol, fill_factor):
    """Native ILUT.  Returns ((Lp,Li,Lx),(Up,Ui,Ux)) or None."""
    lib = get_lib()
    if lib is None:
        return None
    hL = lib.csr_result_new()
    hU = lib.csr_result_new()
    try:
        lib.ilut(n, np.ascontiguousarray(indptr, np.int64),
                 np.ascontiguousarray(indices, np.int32),
                 np.ascontiguousarray(data, np.float64),
                 float(drop_tol), float(fill_factor), hL, hU)
        return _copy_out(lib, hL), _copy_out(lib, hU)
    finally:
        lib.csr_result_free(hL)
        lib.csr_result_free(hU)


def levelize(indptr, indices, n, lower: bool):
    lib = get_lib()
    if lib is None:
        return None
    out = np.zeros(n, dtype=np.int64)
    lib.levelize(n, np.ascontiguousarray(indptr, np.int64),
                 np.ascontiguousarray(indices, np.int32),
                 1 if lower else 0, out)
    return out


def aggregate(indptr, indices, n):
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(n, dtype=np.int64)
    n_agg = lib.aggregate(n, np.ascontiguousarray(indptr, np.int64),
                          np.ascontiguousarray(indices, np.int32), out)
    return out, int(n_agg)


def rcm(indptr, indices, n):
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(n, dtype=np.int64)
    lib.rcm(n, np.ascontiguousarray(indptr, np.int64),
            np.ascontiguousarray(indices, np.int32), out)
    return out


def sym_rcm(indptr, indices, n):
    """RCM of the symmetrized adjacency A + A^T, symmetrization done in
    C++ by counting sort (avoids the two numpy lexsorts a host CSR
    transpose-and-add costs).  Returns the permutation or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "sym_rcm"):
        return None
    out = np.empty(n, dtype=np.int64)
    lib.sym_rcm(n, np.ascontiguousarray(indptr, np.int64),
                np.ascontiguousarray(indices, np.int32), out)
    return out


def csr_permute_plan(indptr, indices, perm):
    """Reorder plan for P·A·Pᵀ (new row i = old row perm[i]): returns
    (order, new_indptr, new_indices) — new data = old data[order] — or
    None.  C++ segment-copy + per-row sort, parallel over row chunks;
    replaces a 2-key numpy lexsort over nnz (~6 s → ~0.6 s at 29M nnz)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "csr_permute_plan"):
        return None
    n = len(indptr) - 1
    nnz = int(indptr[-1])
    out_indptr = np.empty(n + 1, dtype=np.int64)
    out_indices = np.empty(nnz, dtype=np.int32)
    out_order = np.empty(nnz, dtype=np.int64)
    lib.csr_permute_plan(n, np.ascontiguousarray(indptr, np.int64),
                         np.ascontiguousarray(indices, np.int32),
                         np.ascontiguousarray(perm, np.int64),
                         out_indptr, out_indices, out_order)
    return out_order, out_indptr, out_indices


def csr_matvec(indptr, indices, data, x):
    """y = A x in f64 (native sequential loop).  Returns y or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "csr_matvec"):
        return None
    n = len(indptr) - 1
    y = np.empty(n, dtype=np.float64)
    lib.csr_matvec(n, np.ascontiguousarray(indptr, np.int64),
                   np.ascontiguousarray(indices, np.int32),
                   np.ascontiguousarray(data, np.float64),
                   np.ascontiguousarray(x, np.float64), y)
    return y


def mtx_read(path: str, nnz_cap: int):
    lib = get_lib()
    if lib is None:
        return None
    rows = np.empty(nnz_cap, dtype=np.int64)
    cols = np.empty(nnz_cap, dtype=np.int64)
    vals = np.empty(nnz_cap, dtype=np.float64)
    shape = np.zeros(2, dtype=np.int64)
    sym = ctypes.c_int32(0)
    got = lib.mtx_read(path.encode(), rows, cols, vals, nnz_cap, shape,
                       ctypes.byref(sym))
    if got < 0:
        return None
    return (rows[:got], cols[:got], vals[:got], (int(shape[0]),
            int(shape[1])), bool(sym.value))
