"""pysolvers_tpu_torch — the PyTorch/CUDA port of pysolvers_tpu.

A second package beside the JAX one, ported slice by slice (ROADMAP.md).
It imports torch and numpy and never jax or pysolvers_tpu.  It carries
the main path: PCG preconditioned by smoothed-aggregation AMG at native
precision, with every banded operator applied by the hand-written CUDA
kernel K1 (``csrc/dia_spmv.cu``) on an NVIDIA H100, and the unstructured
(BWS) lane, whose operators are applied by K2/K3 (``csrc/bws_spmv.cu``),
and the block-DIA lane of ``solve()`` (single- and multi-RHS), whose
block operators are applied by K4/K5 (``csrc/bdia_spmv.cu``).

Layers (bottom-up):
  sparse/    host CSR + device DIA/ELL/BWS/block-DIA containers
  ops/       SpMV and SpMM (K1, K2/K3, K4/K5 and their plain twins, ELL
             gather), the K7 lane-index probe, triangular solves, the
             nvcc build of ``csrc/``
  linear/    CG (single- and lockstep multi-RHS), Identity/Jacobi
             preconditioners, SA-AMG, block preconditioners
  problems/  FD (scalar and vector) Laplacians, unstructured FEM and
             graph Laplacians
  api        factory types, config, SolveStatus (reference API surface)
  solve      one-call front end
  convert    builds the port's objects from the JAX package's arrays
"""

__version__ = "0.1.0"

from . import ops, problems, sparse, linear
from .core import SolverConfig, SolveStatus, StopReason
from .sparse import HostCSR, EllMatrix, DiaMatrix, BwsMatrix, BdiaMatrix
from .ops import matvec, matmat
from .linear import cg_solve
from .problems import fd_vector_laplacian_2d
from . import api
from .api import (CommonSolverArgs, PCG, LinearSolverType,
                  IterativeLinearSolverType, as_device_matrix)
from .linear.preconditioner import (IdentityPreconditionerType,
                                    JacobiPreconditionerType)
from .linear.amg import AMG, AMGPreconditionerType, AMGVCycle
from .solve import solve

__all__ = [
    "SolverConfig", "SolveStatus", "StopReason", "CommonSolverArgs",
    "HostCSR", "EllMatrix", "DiaMatrix", "BwsMatrix", "BdiaMatrix",
    "matvec", "matmat", "cg_solve", "fd_vector_laplacian_2d",
    "PCG", "LinearSolverType", "IterativeLinearSolverType",
    "as_device_matrix",
    "IdentityPreconditionerType", "JacobiPreconditionerType",
    "AMG", "AMGPreconditionerType", "AMGVCycle",
    "solve",
]
