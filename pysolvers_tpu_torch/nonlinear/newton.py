"""Inexact Newton driver with adaptive linear tolerance and preconditioner
reuse.

Port of ``pysolvers_tpu/nonlinear/newton.py`` (capability parity with
reference PySolvers/Nonlinear/Newton.py:10-101):
* convergence test ||F|| <= r0·tau + tau (Newton.py:54);
* adaptive linear tolerance tau_lin = max(tolFudge·||F||/r0, minLinTol),
  at most 0.5, or a fixed tau_lin for testing (Newton.py:62-73);
* the Newton step J·p = −F by a LinearSolverType factory (Newton.py:21,77);
* line-search globalization (Newton.py:89-93);
* preconditioner freeze across Newton iterations (Newton.py:39 +
  PreconditionerFreeze.py:10-21), as a context manager whose cleanup runs
  (the reference's ``__def__`` typo meant its unfreeze never fired).

The outer loop is host control flow: one norm read per Newton step and per
line-search trial.  A numpy ``x_init`` keeps the iterate in numpy at its
own dtype, longdouble included (the JAX package's host-outer design: with
``problems.Bratu2DHostOuter`` F is evaluated on the host); the inner
solution comes back from the device once per step.  Any other ``x_init``
becomes a tensor on the solver's device and stays there.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..api import DefaultDirect, IterativeLinearSolver, LinearSolverType
from ..core import SolverConfig, SolveStatus, StopReason
from ..sparse.device import resolve_device, torch_dtype
from .linesearch import LineSearchBase, SimpleBacktrack


class PreconditionerFreeze:
    """Freeze a solver's preconditioner for a scope (reference
    PreconditionerFreeze.py:3-24, with working cleanup)."""

    def __init__(self, solver, enable: bool = True):
        self.solver = solver
        self.enable = enable and isinstance(solver, IterativeLinearSolver)

    def __enter__(self):
        if self.enable:
            self.solver.freeze_prec()
        return self

    def __exit__(self, *exc):
        if self.enable:
            self.solver.unfreeze_prec()
        return False


class NewtonSolver:
    """``device``: where a tensor iterate lives and where the default
    ``DefaultDirect`` solves (None: the current CUDA device)."""

    def __init__(self, control: Optional[SolverConfig] = None,
                 solver: Optional[LinearSolverType] = None,
                 linesearch: Optional[LineSearchBase] = None,
                 fix_lin_tol: bool = False, tol_fudge: float = 0.1,
                 min_lin_tol: float = 1e-10, freeze_prec: bool = False,
                 device=None):
        self.device = resolve_device(device)
        self.control = control or SolverConfig(maxiter=20, tau=1e-10)
        self.solver_type = solver or DefaultDirect(device=self.device)
        self.linesearch = linesearch or SimpleBacktrack()
        self.fix_lin_tol = fix_lin_tol
        self.tol_fudge = tol_fudge
        self.min_lin_tol = min_lin_tol
        self.freeze_prec = freeze_prec

    def solve(self, func, x_init) -> SolveStatus:
        """``func`` exposes evalF(x) and evalJ(x) (reference Newton.py:35,59).

        Near tight tolerances the limiting error is the f64 quantization of
        x itself (a last Newton step of ~1e-15 on O(1) values rounds into
        ||J||·ulp residual noise ~1e-11 on Bratu m = 100 at tau = 1e-12);
        a numpy longdouble ``x_init`` pushes that floor down ~2000×.
        """
        control_norm = self.control.norm_fn()

        def norm_fn(F):
            return control_norm(torch.as_tensor(F) if isinstance(
                F, np.ndarray) else F)

        tau = self.control.tau
        use_np = isinstance(x_init, np.ndarray)
        if use_np:
            x = x_init
        else:
            x = torch.as_tensor(x_init if isinstance(x_init, torch.Tensor)
                                else np.asarray(x_init), device=self.device)
        solver = self.solver_type.make_solver()
        history = []

        F = func.evalF(x)
        norm_f = float(norm_fn(F))
        r0 = norm_f
        history.append(norm_f)

        def status(success, iters, reason, msg=""):
            return SolveStatus(success=success, soln=x, resid=norm_f,
                               iters=iters, reason=reason, msg=msg,
                               resid_history=np.asarray(history))

        with PreconditionerFreeze(solver, self.freeze_prec):
            for it in range(self.control.maxiter):
                if norm_f <= r0 * tau + tau:
                    return status(True, it, StopReason.CONVERGED)
                J = func.evalJ(x)
                if isinstance(solver, IterativeLinearSolver):
                    if self.fix_lin_tol:
                        tau_lin = self.tol_fudge
                    else:
                        tau_lin = max(self.tol_fudge * norm_f / r0,
                                      self.min_lin_tol) if r0 > 0 else \
                            self.min_lin_tol
                    solver.set_tolerance(min(tau_lin, 0.5))
                st = solver.solve(J, -F)
                if not st.success:
                    return status(False, it, StopReason.INNER_SOLVE_FAIL,
                                  f"inner linear solve failed: {st.msg}")
                p = st.soln
                if use_np:
                    # the update stays in numpy at x's dtype (a tensor would
                    # drop longdouble to f64, a fixed f64 promote f32)
                    if isinstance(p, torch.Tensor):
                        p = p.detach().cpu().numpy()
                    p = np.asarray(p, dtype=x.dtype)
                x, F, norm_f, ok = self.linesearch.search(
                    x, norm_f, p, func, norm_fn)
                history.append(norm_f)
                if not ok:
                    return status(False, it + 1, StopReason.LINESEARCH_FAIL,
                                  "line search failed to find sufficient "
                                  "decrease")

        if norm_f <= r0 * tau + tau:
            return status(True, self.control.maxiter, StopReason.CONVERGED)
        return status(not self.control.fail_on_maxiter, self.control.maxiter,
                      StopReason.MAXITER, "Newton reached maxiter")


class FuncAdapter1D:
    """Adapt scalar f, f' to the vector evalF/evalJ protocol (reference
    Nonlinear/FuncAdapter1D.py:4-24): 1-element tensors on x's device in
    x's dtype (a numpy x: on the CPU, a longdouble one in f64, the widest
    type torch has)."""

    def __init__(self, f, df):
        self.f = f
        self.df = df

    @staticmethod
    def _like(x, rows):
        if isinstance(x, torch.Tensor):
            return torch.tensor(rows, dtype=x.dtype, device=x.device)
        dt = np.asarray(x).dtype
        return torch.tensor(rows, dtype=torch_dtype(
            dt if dt.itemsize <= 8 else np.float64))

    def evalF(self, x):
        return self._like(x, [self.f(float(x[0]))])

    def evalJ(self, x):
        return self._like(x, [[self.df(float(x[0]))]])
