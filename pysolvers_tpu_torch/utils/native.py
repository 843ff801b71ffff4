"""ctypes bindings for the native setup libraries.

``native/pst_native.cpp`` (SpGEMM, ILUT, aggregation, RCM, ...) is bound as
in ``pysolvers_tpu/utils/native.py`` (importing that package imports jax);
both packages bind the SAME ``native/libpst_native.so``.  The port's own
passes, ``sa_prolongator`` and ``csr_transpose``, live in
``pysolvers_tpu_torch/csrc/sa_setup.cpp`` and are built into
``pysolvers_tpu_torch/_build/libsa_setup.so``.

Both libraries are built with g++ at first use when missing or older than
their source; every entry point has a pure-numpy fallback in the Python
layer, so the framework degrades gracefully on hosts without a toolchain
(``PST_NO_NATIVE=1`` forces the fallback).  A port library that cannot be
built warns once, since its fallback is slower, not wrong.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import warnings
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")

_SETUP_LIB: Optional[ctypes.CDLL] = None
_SETUP_TRIED = False
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SETUP_SRC = os.path.join(_PKG_DIR, "csrc", "sa_setup.cpp")
_SETUP_SO = os.path.join(_PKG_DIR, "_build", "libsa_setup.so")


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


def _build_setup() -> str:
    """Compile ``csrc/sa_setup.cpp`` unless its library is up to date (to a
    temporary name renamed into place, as ``_build``); raises on failure.
    ``-ffp-contract=off`` keeps every product rounded before its add, which
    the passes' bit-equality with numpy needs."""
    so = _SETUP_SO
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(
            _SETUP_SRC):
        return so
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.build.{os.getpid()}"
    try:
        subprocess.run(["g++", "-O3", "-std=c++17", "-ffp-contract=off",
                        "-pthread", "-shared", "-fPIC", "-o", tmp,
                        _SETUP_SRC], check=True, capture_output=True)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    os.replace(tmp, so)
    return so


def get_setup_lib() -> Optional[ctypes.CDLL]:
    """The port's ``libsa_setup.so``, built at first use; None under
    ``PST_NO_NATIVE`` or, with one warning, where it cannot be built or
    loaded."""
    global _SETUP_LIB, _SETUP_TRIED
    if _SETUP_TRIED:
        return _SETUP_LIB
    _SETUP_TRIED = True
    if os.environ.get("PST_NO_NATIVE"):
        return None
    try:
        lib = ctypes.CDLL(_build_setup())
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        warnings.warn("pysolvers_tpu_torch: the native SA setup passes "
                      f"could not be built or loaded ({e}; "
                      f"{detail.decode(errors='replace')[-500:]}); "
                      "sa_coarsen and HostCSR.transpose take the slower "
                      "numpy routes", RuntimeWarning, stacklevel=2)
        return None
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.sa_prolongator.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p,
                                   i32p, f64p, u8p, i64p, ctypes.c_double,
                                   i64p, i32p, f64p, i64p]
    lib.sa_prolongator.restype = ctypes.c_int32
    lib.csr_transpose.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p, i32p,
                                  ctypes.c_void_p, ctypes.c_int64, i64p,
                                  i32p, ctypes.c_void_p]
    lib.csr_transpose.restype = ctypes.c_int32
    _SETUP_LIB = lib
    return _SETUP_LIB


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


def sa_prolongator(indptr, indices, data, strong, agg, n_agg: int,
                   omega: float):
    """SA's smoothed prolongator P = (I − ω·D_f⁻¹·A_f)·P̂ of an f64 CSR A,
    its strength mask per entry and its aggregates, in one row-parallel
    pass bit-equal to ``linear/amg.py``'s numpy route.  Returns
    (indptr, indices, data), or None where the library is unavailable or
    leaves the matrix to that route (a row lumping weak entries with no
    stored diagonal, an id out of range)."""
    lib = get_setup_lib()
    if lib is None:
        return None
    n = len(indptr) - 1
    nnz = int(indptr[-1])
    strong = np.ascontiguousarray(strong, dtype=bool).view(np.uint8)
    if len(indices) != nnz or len(data) != nnz or len(strong) != nnz \
            or len(agg) != n:
        return None
    # outputs sized for the most P can hold (a row of A plus agg[i]),
    # shrunk in place to P's count
    out_indptr = np.empty(n + 1, dtype=np.int64)
    out_indices = np.empty(nnz + n, dtype=np.int32)
    out_data = np.empty(nnz + n, dtype=np.float64)
    out_nnz = np.zeros(1, dtype=np.int64)
    status = lib.sa_prolongator(
        n, int(n_agg), np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int32),
        np.ascontiguousarray(data, np.float64), strong,
        np.ascontiguousarray(agg, np.int64), float(omega), out_indptr,
        out_indices, out_data, out_nnz)
    if status != 0:
        return None
    out_indices.resize(int(out_nnz[0]), refcheck=False)
    out_data.resize(int(out_nnz[0]), refcheck=False)
    return out_indptr, out_indices, out_data


def csr_transpose(indptr, indices, data, shape):
    """Aᵀ by a counting pass: (indptr, indices, data) with each new row's
    entries in old-row order, the arrays of a stable argsort of the
    column ids, data in its own dtype.  None where the library is
    unavailable, the values are not 4- or 8-byte numbers, or the arrays
    do not form a CSR of ``shape``."""
    lib = get_setup_lib()
    if lib is None:
        return None
    n_rows, n_cols = shape
    data = np.ascontiguousarray(data)
    if (data.dtype.kind not in "iuf" or data.itemsize not in (4, 8)
            or len(indptr) != n_rows + 1 or len(indices) != int(indptr[-1])
            or len(data) != len(indices)):
        return None
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    out_indptr = np.empty(n_cols + 1, dtype=np.int64)
    out_indices = np.empty(len(indices), dtype=np.int32)
    out_data = np.empty_like(data)
    status = lib.csr_transpose(n_rows, n_cols, indptr, indices,
                               data.ctypes.data, data.itemsize, out_indptr,
                               out_indices, out_data.ctypes.data)
    return (out_indptr, out_indices, out_data) if status == 0 else None


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
