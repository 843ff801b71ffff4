"""A multigrid level's weighted-Jacobi sweep and residual, each one kernel
launch where the level's format allows it.

* ``jacobi_sweep(A, x, f, dinv, omega)`` — x + (omega·dinv)·(f − A x).
* ``residual(A, f, x)`` — f − A x.

They take the kernel route on CUDA for a square ``DiaMatrix`` (K1,
``csrc/dia_spmv.cu``) or ``GridDiaMatrix`` (K6, ``csrc/grid_dia_spmv.cu``)
whose vectors share its dtype, device and length, are contiguous, and are
not wrapped by a ``torch.func`` transform.  There one launch computes the
product and its epilogue (``csrc/sweep_epilogue.cuh``): the product never
reaches device memory, and the sweep moves (D + 4) words a row where the
product and four elementwise passes moved (D + 13).  The epilogue rounds
each operation on its own, in the order of the lines below, so the fused
result equals theirs on the card bit for bit.  Anywhere else (the CPU, ELL
and BWS levels, rectangular operators, mixed dtypes) they run those lines:
the product by ``matvec``, then torch's elementwise passes.

Each sweep counts "smooth.jacobi_sweeps" and, where the kernel served it,
"smooth.fused_sweeps" (``Timer`` counters, always on; a CUDA graph's replay
runs no Python and counts nothing).
"""
from __future__ import annotations

import torch

from ..sparse.device import DiaMatrix
from ..utils.timing import Timer
from . import _cuda_build
from .grid_spmv import GridDiaMatrix, k6_launch
from .spmv import _functorch_wrapped, k1_launch, matvec


def epilogue_takes(A, *vectors) -> bool:
    """Whether K1's or K6's epilogue computes an op of A on these vectors:
    a square DIA or grid-DIA operator of f32 or f64 on a CUDA device, and
    vectors of its dtype, device and length, contiguous and not wrapped by
    a ``torch.func`` transform."""
    if (not isinstance(A, (DiaMatrix, GridDiaMatrix))
            or A.device.type != "cuda"):
        return False
    n, n_cols = A.shape
    if n != n_cols or A.dtype not in (torch.float32, torch.float64):
        return False
    return all(not _functorch_wrapped(v) and v.dtype == A.dtype
               and v.device == A.device and tuple(v.shape) == (n,)
               and v.is_contiguous() for v in vectors)


def _launch(A, x, f, dinv, omega: float, epilogue: int) -> torch.Tensor:
    launch = k1_launch if isinstance(A, DiaMatrix) else k6_launch
    return launch(A, x, f, dinv, omega, epilogue)


def residual(A, f: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """f − A x."""
    if epilogue_takes(A, x, f):
        return _launch(A, x, f, None, 0.0, _cuda_build.RESIDUAL)
    return f - matvec(A, x)


def jacobi_sweep(A, x: torch.Tensor, f: torch.Tensor, dinv: torch.Tensor,
                 omega: float) -> torch.Tensor:
    """One weighted-Jacobi sweep on A x = f: x + (omega·dinv)·(f − A x),
    a new tensor (the sweep reads the old x of every row's neighbours)."""
    Timer.count("smooth.jacobi_sweeps")
    if epilogue_takes(A, x, f, dinv):
        Timer.count("smooth.fused_sweeps")
        return _launch(A, x, f, dinv, omega, _cuda_build.JACOBI)
    r = f - matvec(A, x)
    return x + omega * dinv.to(x.dtype) * r
