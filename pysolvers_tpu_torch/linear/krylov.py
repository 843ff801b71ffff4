"""Preconditioned conjugate gradients.

Port of ``cg_solve`` in ``pysolvers_tpu/linear/krylov.py`` (reference
PySolvers/Linear/PCGSolver.py:64-145: right-preconditioned CG with
breakdown checks on u·r and p·Ap, convergence on ||r|| <= tau*||b||,
trivial-b shortcut).

The JAX ``lax.while_loop`` becomes a Python loop that reads the stop
reason back to the host once per iteration (one device sync each).
Capturing the iteration in a CUDA graph, and checking the reason less
often, is later work (ROADMAP slice 3).

Not ported: ``richardson_solve``, the multi-RHS and GMRES solvers
(ROADMAP slices 3, 8 and 10).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..core import StopReason


class KrylovState(NamedTuple):
    k: int                # iteration count
    resid: torch.Tensor   # current residual norm (0-d)
    reason: int           # StopReason


def _dot(a, b):
    return torch.sum(a * b)


def _stop_reason(converged, breakdown, k: int, maxiter: int) -> int:
    """CONVERGED > BREAKDOWN > MAXITER > RUNNING, as the JAX loop orders
    them; the one host read of the iteration."""
    last = StopReason.MAXITER if k >= maxiter else StopReason.RUNNING
    code = torch.where(converged, int(StopReason.CONVERGED),
                       torch.where(breakdown, int(StopReason.BREAKDOWN),
                                   int(last)))
    return int(code)


def cg_solve(matvec: Callable, b: torch.Tensor,
             x0: Optional[torch.Tensor] = None, *, maxiter: int = 100,
             tau: float = 1e-8, precond: Optional[Callable] = None,
             norm_fn: Optional[Callable] = None,
             iter_callback: Optional[Callable] = None):
    """Preconditioned conjugate gradients.  Returns (x, KrylovState, history).

    ``precond`` applies M⁻¹ (right/SPD preconditioning as in the reference's
    PCG: u = M⁻¹ r, beta = (u·r)_new/(u·r)_old — PCGSolver.py:109-138).
    ``history`` holds the residual norm of every iteration (NaN beyond the
    last).  ``iter_callback(k, resid)`` is called after every iteration —
    the live equivalent of the reference's reportIter printing
    (IterativeSolver.py:90-99).
    """
    norm = norm_fn or (lambda v: torch.sqrt(_dot(v, v)))
    M = precond or (lambda v: v)
    if x0 is None:
        x0 = torch.zeros_like(b)

    b_norm = norm(b)
    tol = tau * b_norm

    x = x0
    r = b - matvec(x0)
    p = M(r)
    u_dot_r = _dot(p, r)
    resid = norm(r)
    history = torch.full((maxiter + 1,), float("nan"), dtype=resid.dtype,
                         device=resid.device)
    history[0] = resid

    # trivial b / already converged at x0
    k = 0
    reason = _stop_reason(resid <= tol, u_dot_r == 0, 0, 1)
    while reason == StopReason.RUNNING:
        Ap = matvec(p)
        pAp = _dot(p, Ap)
        breakdown_pap = pAp == 0
        alpha = torch.where(breakdown_pap, 0.0, u_dot_r / pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        resid = norm(r)
        u = M(r)
        udr_new = _dot(u, r)
        breakdown_udr = udr_new == 0
        beta = torch.where(u_dot_r == 0, 0.0, udr_new / u_dot_r)
        p = u + beta * p
        u_dot_r = udr_new
        k += 1
        if k <= maxiter:        # maxiter=0 still runs one iteration
            history[k] = resid
        if iter_callback is not None:
            iter_callback(k, resid)
        reason = _stop_reason(resid <= tol, breakdown_pap | breakdown_udr,
                              k, maxiter)
    return x, KrylovState(k, resid, reason), history
