from .krylov import cg_solve, cg_solve_multi_rows, KrylovState
from .preconditioner import (Preconditioner, PreconditionerType,
                             IdentityPreconditionerType,
                             JacobiPreconditionerType,
                             ChebyshevPreconditionerType)

__all__ = [
    "cg_solve", "cg_solve_multi_rows", "KrylovState",
    "Preconditioner", "PreconditionerType", "IdentityPreconditionerType",
    "JacobiPreconditionerType", "ChebyshevPreconditionerType",
]
