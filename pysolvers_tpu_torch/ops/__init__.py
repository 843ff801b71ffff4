from .grid_spmv import GridDiaMatrix, grid_dia_spmv, grid_dia_spmv_torch
from .spmv import (matvec, matmat, dia_spmv, dia_spmv_torch, ell_spmv_torch,
                   ell_spmm_torch,
                   bdia_spmv, bdia_spmv_torch, bdia_spmm, bdia_spmm_rows,
                   bdia_spmm_torch, dia_spmm, dia_spmm_rows, per_vector)
from .sweep import jacobi_sweep, residual

__all__ = ["matvec", "matmat", "dia_spmv", "dia_spmv_torch", "ell_spmv_torch",
           "ell_spmm_torch",
           "bdia_spmv", "bdia_spmv_torch", "bdia_spmm", "bdia_spmm_rows",
           "bdia_spmm_torch", "dia_spmm", "dia_spmm_rows", "per_vector",
           "GridDiaMatrix",
           "grid_dia_spmv", "grid_dia_spmv_torch", "jacobi_sweep",
           "residual"]
