from .krylov import cg_solve, KrylovState
from .preconditioner import (Preconditioner, PreconditionerType,
                             IdentityPreconditionerType,
                             JacobiPreconditionerType)

__all__ = [
    "cg_solve", "KrylovState",
    "Preconditioner", "PreconditionerType", "IdentityPreconditionerType",
    "JacobiPreconditionerType",
]
