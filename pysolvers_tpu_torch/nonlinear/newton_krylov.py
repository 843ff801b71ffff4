"""Matrix-free Newton-Krylov.

Port of ``pysolvers_tpu/nonlinear/newton_krylov.py`` (the working form of
the reference's broken NewtonKrylov module, SURVEY §2.2: a self-contained
Newton-GMRES with total-iteration counting and adaptive tolerances):

* J(x)·v comes from ``torch.func.jvp`` of the residual function (exact
  forward-mode AD) — the Jacobian is never formed.  Kernel K1 takes part
  through its ``autograd.Function`` (``ops/spmv.py::_DiaSpmvFn``): the
  tangent of a DIA product is a second K1 launch.  Every other kernel
  raises under the transform;
* Eisenstat-Walker-style inner tolerance
  tau_lin = min(max(tol_fudge·||F||/r0, min_lin_tol), 0.5) (reference
  Newton.py:62-73) and the Dennis-Schnabel sufficient-decrease
  backtracking (reference LineSearch.py:62-81).

The JAX function is one ``lax.while_loop`` nest under jit; here it is a
host loop over torch ops that computes the same iterates.  Its line search
stops at the first accepted step, which is the trial the JAX masked loop
keeps.  One norm read per Newton step and per line-search trial, besides
the inner solver's own reads.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core import StopReason
from ..linear.krylov import cg_solve, gmres_solve
from ..ops.spmv import matvec
from ..sparse.device import resolve_device


class NKState(NamedTuple):
    k: int              # Newton iterations
    inner_total: int    # total Krylov iterations (the reference
    #                     NewtonKrylov's intent, :80,130)
    resid: float        # ||F(x)||
    reason: int         # StopReason


def newton_krylov_solve(F: Callable, x0, *, tau: float = 1e-10,
                        maxiter: int = 30, method: str = "gmres",
                        inner_maxiter: int = 100,
                        restart: Optional[int] = None,
                        tol_fudge: float = 0.1, min_lin_tol: float = 1e-10,
                        ls_maxsteps: int = 15, ls_alpha: float = 1e-4,
                        ls_low: float = 0.1,
                        precond: Optional[Callable] = None,
                        eval_j: Optional[Callable] = None,
                        precond_from_j: Optional[Callable] = None,
                        device=None):
    """Solve F(x) = 0.  Returns (x, NKState).

    Convergence: ||F|| <= r0·tau + tau (reference Newton.py:54).  The
    iterate lives on ``device`` (None: the current CUDA device), where F
    must take it.

    Matrix-free by default (J·v by jvp).  The explicit-Jacobian path
    (reference Newton.py:59 ``J = func.evalJ(x)``): ``eval_j(x)`` returns a
    device matrix (e.g. ``problems.Bratu2D.eval_j_dev``'s DIA diagonal
    bump), the inner Krylov runs ``matvec(J, v)``, and
    ``precond_from_j(J, v)`` may apply a setup-free preconditioner of the
    current Jacobian (Jacobi, Chebyshev) each Newton step.
    """
    if method not in ("cg", "gmres"):
        raise ValueError(f"method must be 'cg' or 'gmres', got {method!r}")
    x = torch.as_tensor(x0 if isinstance(x0, torch.Tensor)
                        else np.asarray(x0), device=resolve_device(device))

    def norm(v):
        return float(torch.sqrt(torch.sum(v * v)))

    Fx = F(x)
    normF = r0 = norm(Fx)
    tol = r0 * tau + tau

    def line_search(p):
        """The first trial of the backtracking sequence that decreases
        ||F|| enough, or (x, F(x), ||F||, False)."""
        t = 1.0
        for _ in range(ls_maxsteps):
            x_try = x + t * p
            F_try = F(x_try)
            n_try = norm(F_try)
            if np.isfinite(n_try) and n_try <= (1.0 - ls_alpha * t) * normF:
                return x_try, F_try, n_try, True
            ratio = n_try / normF if normF > 0 else 2.0
            shrink = (0.5 / ratio if np.isfinite(ratio) and ratio > 0
                      else 0.5)
            t *= float(np.clip(shrink, ls_low, 0.5))
        return x, Fx, normF, False

    k = inner_total = 0
    reason = StopReason.CONVERGED if r0 <= tol else StopReason.RUNNING
    while reason == StopReason.RUNNING:
        tau_lin = min(max(tol_fudge * normF / max(r0, 1e-300), min_lin_tol),
                      0.5)
        if eval_j is not None:
            Jx = eval_j(x)
            mv = lambda v: matvec(Jx, v)                   # noqa: E731
            papply = (precond if precond_from_j is None
                      else (lambda v: precond_from_j(Jx, v)))
        else:
            mv = lambda v: torch.func.jvp(F, (x,), (v,))[1]  # noqa: E731
            papply = precond
        if method == "cg":
            p, st, _ = cg_solve(mv, -Fx, maxiter=inner_maxiter, tau=tau_lin,
                                precond=papply)
        else:
            p, st, _ = gmres_solve(mv, -Fx, maxiter=inner_maxiter,
                                   tau=tau_lin, restart=restart,
                                   precond=papply, check_true_residual=False)
        x, Fx, normF, ls_ok = line_search(p)
        k += 1
        inner_total += int(st.k)
        reason = (StopReason.CONVERGED if normF <= tol else
                  StopReason.LINESEARCH_FAIL if not ls_ok else
                  StopReason.MAXITER if k >= maxiter else
                  StopReason.RUNNING)
    return x, NKState(k, inner_total, normF, int(reason))
