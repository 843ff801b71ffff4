from .krylov import (cg_solve, cg_solve_multi, cg_solve_multi_rows,
                     gmres_solve, gmres_solve_multi, KrylovState)
from .preconditioner import (Preconditioner, PreconditionerType,
                             IdentityPreconditionerType,
                             JacobiPreconditionerType,
                             ChebyshevPreconditionerType)
from .ilu import ILUTPreconditionerType, ICPreconditionerType
from .operator import LinearOperator

__all__ = [
    "cg_solve", "cg_solve_multi", "cg_solve_multi_rows", "gmres_solve",
    "gmres_solve_multi", "KrylovState",
    "Preconditioner", "PreconditionerType", "IdentityPreconditionerType",
    "JacobiPreconditionerType", "ChebyshevPreconditionerType",
    "ILUTPreconditionerType", "ICPreconditionerType", "LinearOperator",
]
