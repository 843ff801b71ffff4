"""``solve_bdia``: ``pt.solve(operand, b, tau, maxiter, method, precond,
precision)`` of ``pysolvers_tpu_torch`` on a ``BdiaMatrix`` operand
(``operands/bdia_b5_on_card.py``); the timed call is that ``solve``, the
block lane's normal entry point.

Solver keys: ``maxiter``, ``tau``, ``method``, ``precond`` (one of
``solve()``'s block-lane names, with its defaults: ``solve()`` takes no
other settings of it), ``precision`` (default "native").  ``dtype`` is
the configuration's, or float32 for the control (the program's own f32
path of the same route): b is handed over in it, and the operand is packed
in it.  The solve runs on the operand's device."""


class Route:
    def __init__(self, solver: dict, device: str, dtype: str):
        import torch

        import pysolvers_tpu_torch as pt
        self.b_dtype = getattr(torch, dtype)
        self.pt_solve = pt.solve
        self.kw = dict(tau=solver["tau"], maxiter=solver["maxiter"],
                       method=solver["method"], precond=solver["precond"],
                       precision=solver.get("precision", "native"))

    def solve(self, operand, b):
        """The program's SolveStatus (``soln``, ``iters``, ``success``)."""
        return self.pt_solve(operand, b.to(self.b_dtype), **self.kw)

    def freeze(self):
        """Nothing to freeze: ``solve()`` forms the preconditioner of a
        BdiaMatrix once and keeps it, for as long as the operand's planes
        tensor lives unchanged, in its own cache
        (``pysolvers_tpu_torch/solve.py::_BDIA_SOLVE_CACHE``, keyed on the
        planes and their version counter).  That cache is this entry
        point's frozen state: the warm-up solve fills it, and every later
        solve on the same operand reads it."""
