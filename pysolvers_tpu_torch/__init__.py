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
(``csrc/grid_dia_spmv.cu``).  ``solve(A, b)`` runs with its defaults on
every system: the direct solve for n <= 500, PCG + IC(t) for medium SPD
systems, GMRES + ILUT for nonsymmetric ones (``api.GMRES``,
``api.DefaultDirect``, ``linear/ilu.py``), with one right-hand side or k
(``cg_solve_multi``, ``gmres_solve_multi``), and ``LinearOperator``
composes and inverts operators.  ``NewtonSolver`` and
``nonlinear.newton_krylov_solve`` solve nonlinear systems (Bratu's,
``problems.Bratu2D``) with these solvers inside, K1 for every DIA product
and J·v.

Layers (bottom-up):
  sparse/    host CSR + device DIA/ELL/BWS/block-DIA containers
  ops/       SpMV and SpMM (K1, K2/K3, K4/K5, K6 and their plain twins,
             ELL gather, DIA SpMM), the K7 lane-index probe, triangular
             solves, the nvcc build of ``csrc/``
  linear/    CG and GMRES(m)/FGMRES (single- and lockstep multi-RHS),
             Arnoldi, Identity/Jacobi/Chebyshev, ILU(t)/IC(t), SA- and
             RS-AMG, geometric MG (sparse and structured-grid executors),
             block preconditioners, operator algebra
  nonlinear/ inexact Newton (line searches, preconditioner freeze) and
             matrix-free Newton-Krylov
  problems/  FD (scalar and vector) Laplacians, convection-diffusion,
             unstructured FEM and graph Laplacians, Bratu
  api        factory types, config, SolveStatus (reference API surface)
  solve      one-call front end
  convert    builds the port's objects from the JAX package's arrays
"""

__version__ = "0.1.0"

from . import ops, problems, sparse, linear, nonlinear
from .core import SolverConfig, SolveStatus, StopReason
from .sparse import HostCSR, EllMatrix, DiaMatrix, BwsMatrix, BdiaMatrix
from .ops import matvec, matmat, GridDiaMatrix
from .linear import cg_solve, cg_solve_multi, gmres_solve, gmres_solve_multi
from .problems import fd_convection_diffusion_2d, fd_vector_laplacian_2d
from . import api
from .api import (CommonSolverArgs, PCG, GMRES, DefaultDirect,
                  LinearSolverType, IterativeLinearSolverType,
                  as_device_matrix)
from .linear.ilu import ILUTPreconditionerType, ICPreconditionerType
from .linear.operator import LinearOperator
from .linear.preconditioner import (IdentityPreconditionerType,
                                    JacobiPreconditionerType,
                                    ChebyshevPreconditionerType)
from .linear.amg import AMG, AMGPreconditionerType, AMGVCycle
from .linear.gmg import GMGVCycle, GMGPreconditionerType
from .linear.gmg_grid import (GridHierarchy, build_grid_hierarchy,
                              build_grid_hierarchy_device, v_cycle_grid)
from .nonlinear import (NewtonSolver, FuncAdapter1D, SimpleBacktrack,
                        TrivialLinesearch)
from .solve import solve

# reference-style aliases (ILUTPreconditioner.py:10-31, ICPreconditioner.py:20-29)
RightILUT = ILUTPreconditionerType
LeftILUT = lambda *a, **k: ILUTPreconditionerType(*a, side="left", **k)  # noqa: E731
RightIC = ICPreconditionerType

__all__ = [
    "SolverConfig", "SolveStatus", "StopReason", "CommonSolverArgs",
    "HostCSR", "EllMatrix", "DiaMatrix", "BwsMatrix", "BdiaMatrix",
    "GridDiaMatrix", "matvec", "matmat", "cg_solve", "cg_solve_multi",
    "gmres_solve", "gmres_solve_multi",
    "fd_convection_diffusion_2d", "fd_vector_laplacian_2d",
    "PCG", "GMRES", "DefaultDirect", "LinearSolverType",
    "IterativeLinearSolverType", "as_device_matrix",
    "ILUTPreconditionerType", "ICPreconditionerType", "RightILUT",
    "LeftILUT", "RightIC", "LinearOperator",
    "IdentityPreconditionerType", "JacobiPreconditionerType",
    "ChebyshevPreconditionerType",
    "AMG", "AMGPreconditionerType", "AMGVCycle", "GMGVCycle",
    "GMGPreconditionerType",
    "GridHierarchy", "build_grid_hierarchy", "build_grid_hierarchy_device",
    "v_cycle_grid",
    "NewtonSolver", "FuncAdapter1D", "SimpleBacktrack", "TrivialLinesearch",
    "solve",
]
