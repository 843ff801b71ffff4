"""pysolvers_tpu_torch — the PyTorch/CUDA port of pysolvers_tpu.

A second package beside the JAX one, ported slice by slice (ROADMAP.md).
It imports torch and numpy and never jax or pysolvers_tpu.  It carries
the main path: PCG preconditioned by smoothed-aggregation AMG at native
precision, with every banded operator applied by the hand-written CUDA
kernel K1 (``csrc/dia_spmv.cu``) on an NVIDIA H100, and the unstructured
(BWS) lane, whose operators are applied by K2/K3 (``csrc/bws_spmv.cu``).

Layers (bottom-up):
  sparse/    host CSR + device DIA/ELL/BWS containers
  ops/       SpMV (K1, K2/K3 and their plain twins, ELL gather), the K7
             lane-index probe, triangular solves, the nvcc build of
             ``csrc/``
  linear/    CG, Identity/Jacobi preconditioners, SA-AMG
  problems/  FD Laplacians, unstructured FEM and graph Laplacians
  api        factory types, config, SolveStatus (reference API surface)
  solve      one-call front end
  convert    builds the port's objects from the JAX package's arrays
"""

__version__ = "0.1.0"

from . import ops, problems, sparse, linear
from .core import SolverConfig, SolveStatus, StopReason
from .sparse import HostCSR, EllMatrix, DiaMatrix, BwsMatrix
from .ops import matvec
from .linear import cg_solve
from . import api
from .api import (CommonSolverArgs, PCG, LinearSolverType,
                  IterativeLinearSolverType, as_device_matrix)
from .linear.preconditioner import (IdentityPreconditionerType,
                                    JacobiPreconditionerType)
from .linear.amg import AMG, AMGPreconditionerType, AMGVCycle
from .solve import solve

__all__ = [
    "SolverConfig", "SolveStatus", "StopReason", "CommonSolverArgs",
    "HostCSR", "EllMatrix", "DiaMatrix", "BwsMatrix",
    "matvec", "cg_solve",
    "PCG", "LinearSolverType", "IterativeLinearSolverType",
    "as_device_matrix",
    "IdentityPreconditionerType", "JacobiPreconditionerType",
    "AMG", "AMGPreconditionerType", "AMGVCycle",
    "solve",
]
