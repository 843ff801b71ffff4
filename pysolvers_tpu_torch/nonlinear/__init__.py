from .newton import NewtonSolver, FuncAdapter1D, PreconditionerFreeze
from .linesearch import SimpleBacktrack, TrivialLinesearch, LineSearchBase
from .newton_krylov import newton_krylov_solve, NKState

__all__ = ["NewtonSolver", "FuncAdapter1D", "PreconditionerFreeze",
           "SimpleBacktrack", "TrivialLinesearch", "LineSearchBase",
           "newton_krylov_solve", "NKState"]
