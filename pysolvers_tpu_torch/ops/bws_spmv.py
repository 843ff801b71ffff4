"""Block-window SELL SpMV (see ``sparse/bws.py`` for the format).

Port of ``pysolvers_tpu/ops/bws_spmv.py``:

* ``bws_spmv(A, x)`` — the wrapper of kernel K2 (``csrc/bws_spmv.cu``),
  y' = A'·x' in the pack's ordering: on CUDA one launch over every row
  block of the matrix's device CSR (``A.csr``), whatever ``s_classes``
  holds.  The JAX package runs the segment classes (K3) when the slots
  they skip pay for the extra calls; the device CSR has no padded slots,
  so on the card the classes only add launches.
* ``bws_spmv_by_class(A, x)`` — the wrapper of kernel K3: the same
  product with one launch per segment class, each over the row blocks of
  its tiles.  No solve path calls it.
* ``bws_spmv_torch`` — the plain twin, over the pack's tables, following
  the JAX package's path rule ``use_classes`` (all groups with the full
  segment count, or class by class with each class's count; padded slots
  add exact zeros, so both give one result).

A CPU tensor goes to the twin; a CUDA tensor launches K2/K3 or raises (a
CUDA matrix without its layout included) — it never falls back.

* ``bws_matvec`` — y = A·x in the user's ordering (permutes in and out).

Not ported: the TPU kernels' x window (``_x_window_mode``,
``X2_RESIDENT_BYTES``), the W trailing zero blocks of x, the one-hot MXU
block select, the reduction matmul, and the rounding of a class's
segment count up to 8 — all of them shapes Mosaic needed (see the notes
in ``csrc/bws_spmv.cu``).
"""
from __future__ import annotations

import ctypes

import torch

from ..sparse.bws import (BwsMatrix, CALL_COST_SLOTS, SELECT_DIV_EXACT,
                          SELECT_DIV_FAST)
from . import _cuda_build

# Launches of K2 (bws_spmv) and of K3 (bws_spmv_by_class) since the last
# reset: each wrapper adds one per kernel launch and nowhere else.
bws_spmv_launches = 0
bws_spmv_classes_launches = 0

_ENTRIES: dict = {}


def use_classes(A: BwsMatrix) -> bool:
    """The JAX package's path rule (``ops/bws_spmv.py:239-250``): run the
    segment classes when the slots they save, with their select work,
    outweigh the extra per-call cost.  Only the twin follows it."""
    if len(A.s_classes) <= 1:
        return False
    slots_classed = sum(s_c * len(ids)
                        for s_c, ids in A.s_classes) * A.gt * 128
    saved = A.nnz_slots - slots_classed
    sel_div = SELECT_DIV_FAST if A.fast_select else SELECT_DIV_EXACT
    return (saved * (1.0 + A.win_blocks / sel_div)
            > CALL_COST_SLOTS * (len(A.s_classes) - 1))


def _group_rows_sums(A: BwsMatrix, x: torch.Tensor, groups, S_run: int):
    """(len(groups), group_rows) row sums of the first S_run segments of
    ``groups`` (a slice or an index tensor)."""
    delta = A.delta[groups, :S_run].to(torch.int64)
    if isinstance(groups, slice):
        tiles = torch.arange(A.n_groups, device=x.device) // A.gt
    else:
        tiles = groups // A.gt
    blk = A.base[tiles].to(torch.int64)[:, None] + delta
    col = blk[..., None] * 128 + A.lidx[groups, :S_run].to(torch.int64)
    inside = col < A.n_cols
    xv = torch.where(inside, x[torch.where(inside, col, 0)], 0)
    acc = (A.data[groups, :S_run] * xv).sum(dim=1)          # (G, 128)
    return acc.reshape(-1, A.group_rows, A.slots).sum(dim=2)


def bws_spmv_torch(A: BwsMatrix, x: torch.Tensor) -> torch.Tensor:
    """K2/K3's plain twin, in the pack's ordering."""
    if not use_classes(A):
        y = _group_rows_sums(A, x, slice(None), A.n_segments)
        return y.reshape(-1)[: A.n_rows]
    y = torch.zeros(A.n_groups, A.group_rows, dtype=A.dtype, device=x.device)
    lanes = torch.arange(A.gt, device=x.device)
    start = 0
    for S_c, ids in A.s_classes:
        tiles = A.tile_ids[start: start + len(ids)].to(torch.int64)
        start += len(ids)
        groups = (tiles[:, None] * A.gt + lanes).reshape(-1)
        y[groups] = _group_rows_sums(A, x, groups, S_c)
    return y.reshape(-1)[: A.n_rows]


def _entry(name: str, dtype, index_dtype):
    key = (name, dtype, index_dtype)
    fn = _ENTRIES.get(key)
    if fn is None:
        lib = _cuda_build.load("bws_spmv")
        suffix = ("f32" if dtype == torch.float32 else "f64") + (
            "_i32" if index_dtype == torch.int32 else "_i64")
        fn = getattr(lib, f"{name}_{suffix}")
        n_ptrs = 5 if name == "bws_spmv" else 6
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong]
                       + [ctypes.c_void_p] * n_ptrs
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _ENTRIES[key] = fn
    return fn


def _check(rc: int, kernel: str):
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc}")


def _check_call(A: BwsMatrix, x: torch.Tensor) -> bool:
    """Checks both wrappers share; True when x lies on the CPU (the twin's
    case), False on CUDA, where A must carry its layout."""
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"BWS SpMV takes float32 or float64, got {A.dtype}")
    if x.dtype != A.dtype:
        raise TypeError(f"x is {x.dtype}, the operator {A.dtype}")
    if tuple(x.shape) != (A.n_cols,):
        raise ValueError(f"x has shape {tuple(x.shape)}, the operator "
                         f"{A.shape}")
    if x.device != A.device:
        raise ValueError(f"x is on {x.device}, the operator on {A.device}")
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"BWS SpMV runs on CPU or CUDA, not {x.device}")
    if A.csr is None:
        raise ValueError("this CUDA BwsMatrix has no device CSR layout "
                         "(BwsMatrix builds it when its tables lie on CUDA)")
    if not x.is_contiguous():
        raise ValueError("K2/K3 take a contiguous x")
    return False


def _launch_args(L, x: torch.Tensor, y: torch.Tensor):
    """The arguments after the block list: pointers, x's device and its
    current stream.  A product is mostly host time on the small
    levels: the entry switches to x's device itself, and the raw stream
    handle (the lookup torch's generated kernels use) spares a device
    context and a Stream object per call."""
    dev = x.device.index
    return (L.row_blocks.data_ptr(), L.indptr.data_ptr(),
            L.indices.data_ptr(), L.values.data_ptr(), x.data_ptr(),
            y.data_ptr(), dev, torch._C._cuda_getCurrentRawStream(dev))


def bws_spmv(A: BwsMatrix, x: torch.Tensor) -> torch.Tensor:
    """y' = A'·x' in the pack's ordering (x' = x[perm], y = y'[iperm]).

    ``x`` has length shape[1] (rectangular packs — AMG transfers — are
    supported); the result has length shape[0].  On CUDA: one launch of
    K2 over every row block of ``A.csr``, whatever ``s_classes`` holds;
    on the CPU: the twin."""
    global bws_spmv_launches
    if _check_call(A, x):
        return bws_spmv_torch(A, x)
    L = A.csr
    y = torch.empty(A.n_rows, dtype=A.dtype, device=x.device)
    args = _launch_args(L, x, y)
    _check(_entry("bws_spmv", A.dtype, L.indptr.dtype)(
        args[0], L.n_blocks, *args[1:]), "K2 (bws_spmv)")
    bws_spmv_launches += 1
    _cuda_build.count_launch("K2", A.dtype)
    return y


def bws_spmv_by_class(A: BwsMatrix, x: torch.Tensor) -> torch.Tensor:
    """The same product, class by class: on CUDA one launch of K3 for each
    segment class with row blocks, each writing only its tiles' rows; on
    the CPU the twin.  The solve paths take ``bws_spmv``."""
    global bws_spmv_classes_launches
    if not A.s_classes:
        raise ValueError("the pack has no segment classes")
    if _check_call(A, x):
        return bws_spmv_torch(A, x)
    L = A.csr
    y = torch.empty(A.n_rows, dtype=A.dtype, device=x.device)
    fn = _entry("bws_spmv_classes", A.dtype, L.indptr.dtype)
    args = _launch_args(L, x, y)
    starts = L.class_starts
    for c in range(len(starts) - 1):
        n = starts[c + 1] - starts[c]
        if n == 0:
            continue                # a class of tiles past the last row
        _check(fn(L.class_blocks.data_ptr() + 4 * starts[c], n, *args),
               "K3 (bws_spmv_classes)")
        bws_spmv_classes_launches += 1
        _cuda_build.count_launch("K3", A.dtype)
    return y


def bws_matvec(A: BwsMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A·x in the user's ordering (permutes in, unpermutes out)."""
    yp = bws_spmv(A, x[A.perm.to(torch.int64)])
    return yp[A.iperm.to(torch.int64)]
