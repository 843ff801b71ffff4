"""pysolvers_tpu_torch — the PyTorch/CUDA port of pysolvers_tpu.

A second package beside the JAX one, ported slice by slice (ROADMAP.md).
It imports torch and numpy and never jax or pysolvers_tpu.  It carries
the main path: PCG preconditioned by smoothed-aggregation AMG at native
precision, with every banded operator applied by the hand-written CUDA
kernel K1 (``csrc/dia_spmv.cu``) on an NVIDIA H100, and the unstructured
(BWS) lane, whose operators are applied by K2 (``csrc/bws_spmv.cu``),
the block-DIA lane of ``solve()`` (single- and multi-RHS), whose
block operators are applied by K4/K5 (``csrc/bdia_spmv.cu``), and
structured-grid geometric multigrid (host-Galerkin and device-probed grid
hierarchies), whose stencils on grids of m >= 4096 are applied by K6
(``csrc/grid_dia_spmv.cu``).

Layers (bottom-up):
  sparse/    host CSR + device DIA/ELL/BWS/block-DIA containers
  ops/       SpMV and SpMM (K1, K2/K3, K4/K5, K6 and their plain twins,
             ELL gather, DIA SpMM), the K7 lane-index probe, triangular
             solves, the nvcc build of ``csrc/``
  linear/    CG (single- and lockstep multi-RHS), Identity/Jacobi/
             Chebyshev preconditioners, SA- and RS-AMG, geometric MG
             (sparse and structured-grid executors), block preconditioners
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
from .ops import matvec, matmat, GridDiaMatrix
from .linear import cg_solve
from .problems import fd_vector_laplacian_2d
from . import api
from .api import (CommonSolverArgs, PCG, LinearSolverType,
                  IterativeLinearSolverType, as_device_matrix)
from .linear.preconditioner import (IdentityPreconditionerType,
                                    JacobiPreconditionerType,
                                    ChebyshevPreconditionerType)
from .linear.amg import AMG, AMGPreconditionerType, AMGVCycle
from .linear.gmg import GMGVCycle, GMGPreconditionerType
from .linear.gmg_grid import (GridHierarchy, build_grid_hierarchy,
                              build_grid_hierarchy_device, v_cycle_grid)
from .solve import solve

__all__ = [
    "SolverConfig", "SolveStatus", "StopReason", "CommonSolverArgs",
    "HostCSR", "EllMatrix", "DiaMatrix", "BwsMatrix", "BdiaMatrix",
    "GridDiaMatrix", "matvec", "matmat", "cg_solve",
    "fd_vector_laplacian_2d",
    "PCG", "LinearSolverType", "IterativeLinearSolverType",
    "as_device_matrix",
    "IdentityPreconditionerType", "JacobiPreconditionerType",
    "ChebyshevPreconditionerType",
    "AMG", "AMGPreconditionerType", "AMGVCycle", "GMGVCycle",
    "GMGPreconditionerType",
    "GridHierarchy", "build_grid_hierarchy", "build_grid_hierarchy_device",
    "v_cycle_grid",
    "solve",
]
