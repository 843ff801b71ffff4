from .krylov import cg_solve, cg_solve_multi_rows, gmres_solve, KrylovState
from .preconditioner import (Preconditioner, PreconditionerType,
                             IdentityPreconditionerType,
                             JacobiPreconditionerType,
                             ChebyshevPreconditionerType)
from .ilu import ILUTPreconditionerType, ICPreconditionerType
from .operator import LinearOperator

__all__ = [
    "cg_solve", "cg_solve_multi_rows", "gmres_solve", "KrylovState",
    "Preconditioner", "PreconditionerType", "IdentityPreconditionerType",
    "JacobiPreconditionerType", "ChebyshevPreconditionerType",
    "ILUTPreconditionerType", "ICPreconditionerType", "LinearOperator",
]
