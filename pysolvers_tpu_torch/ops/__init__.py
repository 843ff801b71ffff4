from .spmv import (matvec, matmat, dia_spmv, dia_spmv_torch, ell_spmv_torch,
                   bdia_spmv, bdia_spmv_torch, bdia_spmm, bdia_spmm_rows,
                   bdia_spmm_torch)

__all__ = ["matvec", "matmat", "dia_spmv", "dia_spmv_torch", "ell_spmv_torch",
           "bdia_spmv", "bdia_spmv_torch", "bdia_spmm", "bdia_spmm_rows",
           "bdia_spmm_torch"]
