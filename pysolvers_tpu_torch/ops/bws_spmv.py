"""Block-window SELL SpMV (see ``sparse/bws.py`` for the format).

Port of ``pysolvers_tpu/ops/bws_spmv.py``:

* ``bws_spmv(A, x)`` — the wrapper of kernels K2 and K3
  (``csrc/bws_spmv.cu``), y' = A'·x' in the pack's ordering.  It takes the
  JAX package's path decision unchanged: the class kernel K3 (one launch
  per segment class) when the modelled slot savings beat the extra calls,
  else the plain kernel K2 (one launch).  A CPU tensor goes to the plain
  twin ``bws_spmv_torch``; a CUDA tensor launches K2/K3 or raises — it
  never falls back.
* ``bws_spmv_torch`` — the plain version, following the same path
  decision: over all groups with the full segment count, or class by
  class with each class's count.
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

# Launches of K2 and of K3 since the last reset: bws_spmv adds one per
# kernel launch and nowhere else.
bws_spmv_launches = 0
bws_spmv_classes_launches = 0

_ENTRIES: dict = {}


def use_classes(A: BwsMatrix) -> bool:
    """The JAX package's path rule (``ops/bws_spmv.py:239-250``): run the
    segment classes when the slots they save, with their select work,
    outweigh the extra per-call cost."""
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


def _entry(name: str, dtype):
    key = (name, dtype)
    fn = _ENTRIES.get(key)
    if fn is None:
        lib = _cuda_build.load("bws_spmv")
        suffix = "f32" if dtype == torch.float32 else "f64"
        fn = getattr(lib, f"{name}_{suffix}")
        if name == "bws_spmv":
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 6
                           + [ctypes.c_void_p])
        else:
            fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong]
                           + [ctypes.c_void_p] * 6
                           + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _ENTRIES[key] = fn
    return fn


def _check(rc: int, kernel: str):
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc}")


def bws_spmv(A: BwsMatrix, x: torch.Tensor) -> torch.Tensor:
    """y' = A'·x' in the pack's ordering (x' = x[perm], y = y'[iperm]).

    ``x`` has length shape[1] (rectangular packs — AMG transfers — are
    supported); the result has length shape[0].  K3 on CUDA when the
    classes pay (``use_classes``), else K2; the twin on the CPU."""
    global bws_spmv_launches, bws_spmv_classes_launches
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
        return bws_spmv_torch(A, x)
    if x.device.type != "cuda":
        raise ValueError(f"BWS SpMV runs on CPU or CUDA, not {x.device}")
    if A.group_rows < 4 or 128 % A.group_rows:
        raise ValueError(f"K2/K3 take group_rows dividing 128 with at most "
                         f"32 slots, not {A.group_rows}")
    if not (x.is_contiguous() and A.data.is_contiguous()
            and A.lidx.is_contiguous() and A.delta.is_contiguous()):
        raise ValueError("K2/K3 take contiguous x and tables")
    y = torch.empty(A.n_rows, dtype=A.dtype, device=x.device)
    if A.n_rows == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    common = (A.data.data_ptr(), A.lidx.data_ptr(), x.data_ptr(),
              y.data_ptr(), A.n_rows, A.n_cols)
    with torch.cuda.device(x.device):
        if use_classes(A):
            fn = _entry("bws_spmv_classes", A.dtype)
            start = 0
            for S_c, ids in A.s_classes:
                ids_ptr = A.tile_ids.data_ptr() + 4 * start
                start += len(ids)
                _check(fn(ids_ptr, len(ids), A.base.data_ptr(),
                          A.delta.data_ptr(), *common, A.n_segments, S_c,
                          A.gt, A.group_rows, stream), "K3 (bws_spmv_classes)")
                bws_spmv_classes_launches += 1
        else:
            fn = _entry("bws_spmv", A.dtype)
            _check(fn(A.base.data_ptr(), A.delta.data_ptr(), *common,
                      A.n_groups, A.n_segments, A.gt, A.group_rows, stream),
                   "K2 (bws_spmv)")
            bws_spmv_launches += 1
    return y


def bws_matvec(A: BwsMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A·x in the user's ordering (permutes in, unpermutes out)."""
    yp = bws_spmv(A, x[A.perm.to(torch.int64)])
    return yp[A.iperm.to(torch.int64)]
