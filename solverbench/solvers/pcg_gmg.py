"""``pcg_gmg``: ``pt.PCG(CommonSolverArgs(maxiter, tau), precond=
pt.GMGPreconditionerType(**precond)).make_solver()`` of
``pysolvers_tpu_torch``; the timed call is its ``solve(operand, b)``.

Solver keys: ``maxiter``, ``tau``, ``precond`` (the keyword arguments of
``pt.GMGPreconditionerType`` as given, ``dims`` among them).  ``dtype`` is
the configuration's, or float32 for the control (the program's own f32
path of the same route): b is handed over in it.  The operand may be the
device ``DiaMatrix`` alone (``operands/dia_on_card.py``): the grid
executor's device Galerkin builds from it."""


class Route:
    def __init__(self, solver: dict, device: str, dtype: str):
        import torch

        import pysolvers_tpu_torch as pt
        self.b_dtype = getattr(torch, dtype)
        precond = dict(solver["precond"])
        precond["dims"] = tuple(precond["dims"])
        self.solver = pt.PCG(
            pt.CommonSolverArgs(maxiter=solver["maxiter"], tau=solver["tau"]),
            precond=pt.GMGPreconditionerType(**precond),
            device=device).make_solver()

    def solve(self, operand, b):
        """The program's SolveStatus (``soln``, ``iters``, ``success``)."""
        return self.solver.solve(operand, b.to(self.b_dtype))

    def freeze(self):
        self.solver.freeze_matrix()
        self.solver.freeze_prec()
