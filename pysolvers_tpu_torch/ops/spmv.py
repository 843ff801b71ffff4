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
* ``bdia_spmv`` — the wrapper of kernel K4 (``csrc/bdia_spmv.cu``), the
  replacement of the TPU kernel ``bdia_spmv_pallas``: planar block-DIA
  SpMV for a ``BdiaMatrix``, f32 and f64.  Its twin ``bdia_spmv_torch`` is
  the planar shift-and-FMA of the JAX package's ``_bdia_xla``.
* ``bdia_spmm_rows`` — the wrapper of kernel K5, the replacement of the
  TPU kernel ``bdia_spmm_tiles``: the same product for the k rows of a
  row-layout (k, b·nb) block in one pass over the planes (more than 16
  rows are chunked into several launches).  Twin: ``bdia_spmm_torch``.
  ``bdia_spmm`` takes the (n, k) column form and calls K5 on rows.
* ``dia_spmm`` — Y = A @ X for a DiaMatrix and an (n, k) block: the JAX
  package's shift-and-FMA over the whole block (an XLA function there,
  not a kernel, so plain torch here, updating the sum in place), with its
  rectangular padding rule.  ``dia_spmm_rows`` is the same product on the
  row layout (k, n); the GMG prober calls it on its comb batches.
* ``matvec`` — dispatch by format; a ``BwsMatrix`` goes to ``bws_spmv``
  (kernel K2, ``ops/bws_spmv.py``) in the pack's ordering, a
  ``BdiaMatrix`` to ``bdia_spmv`` in planar ordering, a ``GridDiaMatrix``
  to ``grid_dia_spmv`` (kernel K6, ``ops/grid_spmv.py``), a matrix-free
  operator (``ndim == 2`` and ``@``, ``linear/operator.py``) to its own
  ``@``.  ``matmat`` —
  the multi-vector dispatch: a ``BdiaMatrix`` (K5), a ``DiaMatrix``
  (``dia_spmm``), an ``EllMatrix`` (``ell_spmm_torch``), a ``BwsMatrix``
  (K2 once per column, in the pack's ordering) and dense operators.
* ``ell_spmm_torch`` — Y = A @ X for an EllMatrix by one gather over the
  rows: the counterpart of the JAX package's ``ell_spmm_xla`` (an XLA
  op there, not a kernel), on every device.

K1 under ``torch.func.jvp`` (the matrix-free Newton-Krylov J·v,
``nonlinear/newton_krylov.py``): a transform's wrapped tensor has no data
pointer for the ctypes call, so ``dia_spmv`` hands it to ``_DiaSpmvFn``, an
``autograd.Function`` whose forward runs on the unwrapped tensor and whose
``jvp`` is ``dia_spmv(A, ẋ)`` (SpMV is linear in x): on CUDA a second K1
launch, on the CPU the twin.  The other kernel wrappers have no such
Function; a transformed tensor makes their ctypes call raise.

Every kernel wrapper runs its twin for a CPU tensor, and for a CUDA tensor
launches its kernel or raises — it never falls back.

Not ported: ``DiaTiled``/``prep_operator`` (K1 reads the (D, ld) table as
packed, so there is no layout step), the f64 split-gathers and the f32-only
gates of the block kernels (Mosaic has no f64), and the block kernels' TPU
layout work: ``bdia_rows_to_tiles``/``bdia_tiles_to_rows``,
``bdia_tile_size``, ``bdia_tiles_eligible`` and the halo-tiled
(n_tiles+2, b, k, tile) operand of ``bdia_spmm_tiles`` (Mosaic's VMEM
windows and XLA's 128-lane padding of a k-minor axis — K5 reads the row
layout directly with bounds masks), the VMEM tile budget and x windows of
``bdia_spmv_pallas``.
"""
from __future__ import annotations

import ctypes

import torch

from ..sparse.bdia import BdiaMatrix
from ..sparse.bws import BwsMatrix
from ..sparse.device import DiaMatrix, EllMatrix
from . import _cuda_build
from .bws_spmv import bws_spmv
from .grid_spmv import GridDiaMatrix, grid_dia_spmv

# Launches of K1, K4 and K5 since the last reset: each wrapper adds one per
# kernel launch and nowhere else (a run reads them to show that its path
# went through the kernels).
dia_spmv_launches = 0
bdia_spmv_launches = 0
bdia_spmm_launches = 0

# K1 launches made for the tangent of a ``torch.func.jvp``, counted where
# K1 launches (each also in dia_spmv_launches)
dia_spmv_jvp_launches = 0

_functorch_wrapped = torch._C._functorch.is_functorch_wrapped_tensor

# K5 holds at most this many right-hand sides in registers per launch
BDIA_SPMM_MAX_ROWS = 16

_K1_ENTRIES: dict = {}
_BDIA_ENTRIES: dict = {}


def ell_spmv_torch(A: EllMatrix, x: torch.Tensor) -> torch.Tensor:
    """General SpMV by gather; correct for every dtype and shape."""
    n = A.n_rows
    # +1 slot: padding columns use the sentinel index n_cols (zero there)
    xp = torch.zeros(max(A.n_cols_pad, A.n_cols + 1), dtype=x.dtype,
                     device=x.device)
    xp[: A.n_cols] = x[: A.n_cols]
    g = torch.index_select(xp, 0, A.cols.reshape(-1)).reshape(A.cols.shape)
    return torch.sum(A.data * g, dim=1)[:n]


def ell_spmm_torch(A: EllMatrix, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for an (n_cols, k) block X: one gather of X's rows for
    every slot, summed over the slots (JAX ``ell_spmm_xla``)."""
    n = A.n_rows
    Xp = torch.zeros((max(A.n_cols_pad, A.n_cols + 1), X.shape[1]),
                     dtype=X.dtype, device=X.device)
    Xp[: A.n_cols] = X[: A.n_cols]
    g = torch.index_select(Xp, 0, A.cols.reshape(-1)).reshape(
        *A.cols.shape, X.shape[1])
    return torch.einsum("nk,nkr->nr", A.data, g)[:n]


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


class _DiaSpmvFn(torch.autograd.Function):
    """K1 under ``torch.func`` transforms: the forward runs ``dia_spmv`` on
    the unwrapped x, the tangent is ``dia_spmv(A, ẋ)`` — on CUDA a second
    K1 launch, never the twin.  ``tangent`` marks the product as one made
    for a tangent, so that the launch branch counts it in
    ``dia_spmv_jvp_launches`` (once per launch, at any nesting depth)."""

    @staticmethod
    def forward(A, x, tangent):
        return dia_spmv(A, x, _tangent=tangent)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.A = inputs[0]

    @staticmethod
    def jvp(ctx, _A_tangent, x_tangent, _flag_tangent):
        return dia_spmv(ctx.A, x_tangent, _tangent=True)


def dia_spmv(A: DiaMatrix, x: torch.Tensor, *,
             _tangent: bool = False) -> torch.Tensor:
    """y = A @ x for a DiaMatrix: kernel K1 on CUDA, its twin on the CPU;
    a tensor wrapped by a ``torch.func`` transform goes through
    ``_DiaSpmvFn``."""
    global dia_spmv_launches, dia_spmv_jvp_launches
    if _functorch_wrapped(x):
        return _DiaSpmvFn.apply(A, x, _tangent)
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
    if _tangent:
        dia_spmv_jvp_launches += 1
    _cuda_build.count_launch("K1", A.dtype)
    return y


def bdia_spmm_torch(A: BdiaMatrix, V: torch.Tensor) -> torch.Tensor:
    """Planar block-DIA product of the k rows of V (k, b·nb) in plain
    torch (K5's twin, and K4's through ``bdia_spmv_torch``): for each
    block offset d and source dof q, FMA the (b, nb) plane against dof q's
    shifted, zero-padded x segment, in (d, q) order."""
    b, nb = A.b, A.nb
    k = V.shape[0]
    acc = torch.zeros(k, b, nb, dtype=A.dtype, device=V.device)
    if not A.offsets:
        return acc.reshape(k, b * nb)
    pad_lo = max(0, -min(A.offsets))
    pad_hi = max(0, max(A.offsets))
    # each dof padded on its own: a shift never reads a neighbouring dof
    xp = torch.nn.functional.pad(V.to(A.dtype).reshape(k, b, nb),
                                 (pad_lo, pad_hi))
    for d, off in enumerate(A.offsets):
        xs = xp[:, :, off + pad_lo: off + pad_lo + nb]
        for q in range(b):
            acc = acc + A.planes[d * b + q, :, :nb] * xs[:, q:q + 1, :]
    return acc.reshape(k, b * nb)


def bdia_spmv_torch(A: BdiaMatrix, x: torch.Tensor) -> torch.Tensor:
    """K4's twin: ``bdia_spmm_torch`` on the single row x."""
    return bdia_spmm_torch(A, x.reshape(1, -1)).reshape(-1)


def _bdia_entry(name: str, dtype):
    key = (name, dtype)
    fn = _BDIA_ENTRIES.get(key)
    if fn is None:
        lib = _cuda_build.load("bdia_spmv")
        suffix = "f32" if dtype == torch.float32 else "f64"
        fn = getattr(lib, f"{name}_{suffix}")
        n_ints = 4 if name == "bdia_spmv" else 5
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * n_ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _BDIA_ENTRIES[key] = fn
    return fn


def _check_bdia(A: BdiaMatrix, v: torch.Tensor, what: str) -> bool:
    """Shared argument checks of K4/K5; True when ``v`` is on the CPU (the
    twin's case), False on CUDA, where the kernel's own demands are
    checked too."""
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"block-DIA products take float32 or float64, got "
                        f"{A.dtype}")
    if v.dtype != A.dtype:
        raise TypeError(f"{what} is {v.dtype}, the operator {A.dtype}")
    if v.device != A.device:
        raise ValueError(f"{what} is on {v.device}, the operator on "
                         f"{A.device}")
    if v.device.type == "cpu":
        return True
    if v.device.type != "cuda":
        raise ValueError(f"block-DIA products run on CPU or CUDA, not "
                         f"{v.device}")
    if not (v.is_contiguous() and A.planes.is_contiguous()):
        raise ValueError(f"K4/K5 take a contiguous {what} and planes")
    return False


def bdia_spmv(A: BdiaMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x in planar ordering: kernel K4 on CUDA, its twin on the
    CPU."""
    global bdia_spmv_launches
    if tuple(x.shape) != (A.n_cols,):
        raise ValueError(f"x has shape {tuple(x.shape)}, the operator "
                         f"{A.shape}")
    if _check_bdia(A, x, "x"):
        return bdia_spmv_torch(A, x)
    y = torch.empty(A.n_rows, dtype=A.dtype, device=x.device)
    if A.n_rows == 0:
        return y
    fn = _bdia_entry("bdia_spmv", A.dtype)
    with torch.cuda.device(x.device):
        rc = fn(A.planes.data_ptr(), A.offsets_dev.data_ptr(), x.data_ptr(),
                y.data_ptr(), A.nb, A.nb_pad, A.b, len(A.offsets),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K4 (bdia_spmv) launch failed: CUDA error {rc}")
    bdia_spmv_launches += 1
    _cuda_build.count_launch("K4", A.dtype)
    return y


def bdia_spmm_rows(A: BdiaMatrix, V: torch.Tensor) -> torch.Tensor:
    """Y = (A @ V.T).T for a row-layout block V of shape (k, b·nb), one
    planar right-hand side per row: kernel K5 on CUDA (one launch per 16
    rows), its twin on the CPU."""
    global bdia_spmm_launches
    if V.ndim != 2 or V.shape[1] != A.n_cols:
        raise ValueError(f"V has shape {tuple(V.shape)}, expected (k, "
                         f"{A.n_cols})")
    if _check_bdia(A, V, "V"):
        return bdia_spmm_torch(A, V)
    k = V.shape[0]
    Y = torch.empty(k, A.n_rows, dtype=A.dtype, device=V.device)
    if k == 0 or A.n_rows == 0:
        return Y
    fn = _bdia_entry("bdia_spmm", A.dtype)
    row_bytes = A.n_rows * V.element_size()
    with torch.cuda.device(V.device):
        stream = torch.cuda.current_stream().cuda_stream
        for r0 in range(0, k, BDIA_SPMM_MAX_ROWS):
            kc = min(BDIA_SPMM_MAX_ROWS, k - r0)
            rc = fn(A.planes.data_ptr(), A.offsets_dev.data_ptr(),
                    V.data_ptr() + r0 * row_bytes,
                    Y.data_ptr() + r0 * row_bytes, A.nb, A.nb_pad, A.b,
                    len(A.offsets), kc, stream)
            if rc != 0:
                raise RuntimeError(f"K5 (bdia_spmm) launch failed: CUDA "
                                   f"error {rc}")
            bdia_spmm_launches += 1
            _cuda_build.count_launch("K5", A.dtype)
    return Y


def bdia_spmm(A: BdiaMatrix, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for a planar column block X of shape (n, k): K5 on the
    rows X.T (two layout copies per call; lockstep solvers stay in rows)."""
    return bdia_spmm_rows(A, X.T.contiguous()).T


def dia_spmm_rows(A: DiaMatrix, V: torch.Tensor) -> torch.Tensor:
    """Y = (A @ V.T).T for a row-layout block V of shape (k, n_cols):
    shift-and-FMA over all k rows at once, one pass over the diagonals."""
    n, n_cols = A.shape
    n_pad = A.ld
    k = V.shape[0]
    acc = torch.zeros((k, n_pad), dtype=A.dtype, device=V.device)
    if A.offsets:
        pad_lo = max(0, -min(A.offsets))
        # pad against V's row length (= n_cols), NOT n_rows — the
        # rectangular-operator clamping hazard of dia_spmv_torch
        pad_hi = max(0, max(0, max(A.offsets)) + n_pad - n_cols)
        Vp = torch.nn.functional.pad(V.to(A.dtype), (pad_lo, pad_hi))
        for d, off in enumerate(A.offsets):
            acc.addcmul_(A.diags[d], Vp[:, off + pad_lo: off + pad_lo + n_pad])
    return acc[:, :n]


def dia_spmm(A: DiaMatrix, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for banded A and an (n_cols, k) block X: ``dia_spmm_rows``
    on X.T (a transposed view; the result is one too)."""
    return dia_spmm_rows(A, X.T).T


def matvec(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for any device format of the port.

    A BwsMatrix operates in its packed ordering (the identity when packed
    with use_rcm=False, as AMG hierarchies are); a BdiaMatrix in planar
    ordering."""
    if isinstance(A, DiaMatrix):
        return dia_spmv(A, x)
    if isinstance(A, GridDiaMatrix):
        return grid_dia_spmv(A, x)
    if isinstance(A, BdiaMatrix):
        return bdia_spmv(A, x)
    if isinstance(A, BwsMatrix):
        return bws_spmv(A, x)
    if isinstance(A, EllMatrix):
        return ell_spmv_torch(A, x)
    if isinstance(A, torch.Tensor):
        # dense operators here are AMG coarse inverses — small; a float32
        # matmul stays full float32 (allow_tf32 is off for matmul)
        return A @ x
    if getattr(A, "ndim", None) == 2 and hasattr(A, "__matmul__"):
        return A @ x      # duck-typed operator (linear/operator.py)
    raise TypeError(f"unknown matrix type {type(A)}")


def per_vector(apply, dim: int = 1):
    """A block apply from a single-vector one: ``apply`` on each vector of
    the block along ``dim`` (1: the columns of an (n, k) block, 0: the rows
    of a (k, n) one), stacked back along it.  The JAX package's
    ``jax.vmap(apply, in_axes=dim, out_axes=dim)``; here one call, with its
    kernels' launches, per vector (a ctypes launch cannot be mapped)."""
    return lambda V: torch.stack([apply(V.select(dim, j).contiguous())
                                  for j in range(V.shape[dim])], dim=dim)


def matmat(A, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for a multi-vector X of shape (n, k): a BdiaMatrix (planar
    ordering, kernel K5), a DiaMatrix (``dia_spmm``), an EllMatrix
    (``ell_spmm_torch``), a BwsMatrix (K2 once per column, in the pack's
    ordering; on the CPU its twin), a dense or a matrix-free operator."""
    if isinstance(A, BdiaMatrix):
        return bdia_spmm(A, X)
    if isinstance(A, DiaMatrix):
        return dia_spmm(A, X)
    if isinstance(A, EllMatrix):
        return ell_spmm_torch(A, X)
    if isinstance(A, BwsMatrix):
        return per_vector(lambda x: bws_spmv(A, x))(X)
    if isinstance(A, torch.Tensor) or (getattr(A, "ndim", None) == 2
                                       and hasattr(A, "__matmul__")):
        return A @ X
    raise TypeError(f"unknown matrix type {type(A)}")
