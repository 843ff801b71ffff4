from .spmv import matvec, dia_spmv, dia_spmv_torch, ell_spmv_torch

__all__ = ["matvec", "dia_spmv", "dia_spmv_torch", "ell_spmv_torch"]
