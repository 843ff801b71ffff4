"""Sparse matrix–vector products (the solvers' hottest operation).

Port of ``pysolvers_tpu/ops/spmv.py``:

* ``dia_spmv`` — the wrapper of kernel K1 (``csrc/dia_spmv.cu``), the
  hand-written CUDA replacement of the TPU kernel ``dia_spmv_pallas``.
  It serves every ``DiaMatrix`` on a CUDA device, in f32 and f64 alike
  (the JAX package sends f64 to ``dia_spmv_xla`` only because Mosaic has
  no f64).  A CPU tensor goes to the plain twin ``dia_spmv_torch``; a CUDA
  tensor launches K1 or raises — it never falls back.
* ``dia_spmv_torch`` — plain shift-and-FMA (the counterpart of
  ``dia_spmv_xla``): K1's reference in the tests and on the card.
* ``ell_spmv_torch`` — plain gather SpMV for ``EllMatrix`` (the JAX package
  computes it outside any kernel, ``ell_spmv_xla``), on every device.
* ``matvec`` — dispatch by format; a ``BwsMatrix`` goes to ``bws_spmv``
  (kernels K2/K3, ``ops/bws_spmv.py``) in the pack's ordering.

Not ported: ``DiaTiled``/``prep_operator`` (K1 reads the (D, ld) table as
packed, so there is no layout step), the f64 split-gathers (a TPU f64
workaround), and the block-DIA and grid kernels with their SpMM forms
(ROADMAP slices 10 and 11).
"""
from __future__ import annotations

import ctypes

import torch

from ..sparse.bws import BwsMatrix
from ..sparse.device import DiaMatrix, EllMatrix
from . import _cuda_build
from .bws_spmv import bws_spmv

# Launches of K1 since the last reset: dia_spmv adds one per kernel launch
# and nowhere else (a run reads it to show that its path went through K1).
dia_spmv_launches = 0

_K1_ENTRIES: dict = {}


def ell_spmv_torch(A: EllMatrix, x: torch.Tensor) -> torch.Tensor:
    """General SpMV by gather; correct for every dtype and shape."""
    n = A.n_rows
    # +1 slot: padding columns use the sentinel index n_cols (zero there)
    xp = torch.zeros(max(A.n_cols_pad, A.n_cols + 1), dtype=x.dtype,
                     device=x.device)
    xp[: A.n_cols] = x[: A.n_cols]
    g = torch.index_select(xp, 0, A.cols.reshape(-1)).reshape(A.cols.shape)
    return torch.sum(A.data * g, dim=1)[:n]


def dia_spmv_torch(A: DiaMatrix, x: torch.Tensor) -> torch.Tensor:
    """Shift-and-FMA SpMV in plain torch (K1's twin), in offset order."""
    n, n_cols = A.shape
    acc = torch.zeros(n, dtype=A.dtype, device=A.device)
    if not A.offsets:
        return acc
    pad_lo = max(0, -min(A.offsets))
    # pad against x's length (= n_cols), NOT the row count: a tall
    # rectangular operator (e.g. a prolongator) would read past x
    pad_hi = max(0, max(A.offsets) + n - n_cols)
    x = x.to(A.dtype)
    xp = torch.cat([x.new_zeros(pad_lo), x, x.new_zeros(pad_hi)])
    for d, off in enumerate(A.offsets):
        acc = acc + A.diags[d, :n] * xp[off + pad_lo: off + pad_lo + n]
    return acc


def _k1_entry(dtype):
    fn = _K1_ENTRIES.get(dtype)
    if fn is None:
        lib = _cuda_build.load("dia_spmv")
        fn = lib.dia_spmv_f32 if dtype == torch.float32 else lib.dia_spmv_f64
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _K1_ENTRIES[dtype] = fn
    return fn


def dia_spmv(A: DiaMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a DiaMatrix: kernel K1 on CUDA, its twin on the CPU."""
    global dia_spmv_launches
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"DIA SpMV takes float32 or float64, got {A.dtype}")
    if x.dtype != A.dtype:
        raise TypeError(f"x is {x.dtype}, the operator {A.dtype}")
    if tuple(x.shape) != (A.n_cols,):
        raise ValueError(f"x has shape {tuple(x.shape)}, the operator "
                         f"{A.shape}")
    if x.device != A.device:
        raise ValueError(f"x is on {x.device}, the operator on {A.device}")
    if x.device.type == "cpu":
        return dia_spmv_torch(A, x)
    if x.device.type != "cuda":
        raise ValueError(f"DIA SpMV runs on CPU or CUDA, not {x.device}")
    if not (x.is_contiguous() and A.diags.is_contiguous()):
        raise ValueError("K1 takes contiguous x and diagonals")
    y = torch.empty(A.n_rows, dtype=A.dtype, device=x.device)
    if A.n_rows == 0:
        return y
    fn = _k1_entry(A.dtype)
    with torch.cuda.device(x.device):
        rc = fn(A.diags.data_ptr(), A.offsets_dev.data_ptr(), x.data_ptr(),
                y.data_ptr(), A.n_rows, A.n_cols, A.ld, len(A.offsets),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K1 (dia_spmv) launch failed: CUDA error {rc}")
    dia_spmv_launches += 1
    return y


def matvec(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for any device format of the port.

    A BwsMatrix operates in its packed ordering (the identity when packed
    with use_rcm=False, as AMG hierarchies are)."""
    if isinstance(A, DiaMatrix):
        return dia_spmv(A, x)
    if isinstance(A, BwsMatrix):
        return bws_spmv(A, x)
    if isinstance(A, EllMatrix):
        return ell_spmv_torch(A, x)
    if isinstance(A, torch.Tensor):
        # dense operators here are AMG coarse inverses — small; a float32
        # matmul stays full float32 (allow_tf32 is off for matmul)
        return A @ x
    raise TypeError(f"unknown matrix type {type(A)}")
