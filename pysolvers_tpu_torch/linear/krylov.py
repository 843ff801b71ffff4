"""Preconditioned conjugate gradients, single- and multi-RHS.

Port of ``cg_solve``, ``cg_solve_multi_rows`` and ``_cg_lockstep`` in
``pysolvers_tpu/linear/krylov.py`` (reference
PySolvers/Linear/PCGSolver.py:64-145: right-preconditioned CG with
breakdown checks on u·r and p·Ap, convergence on ||r|| <= tau*||b||,
trivial-b shortcut).

The JAX ``lax.while_loop`` becomes a Python loop that reads the stop
reason back to the host once per iteration (one device sync each; the
lockstep solver reads whether any right-hand side is still running).
Capturing the iteration in a CUDA graph, and checking the reason less
often, is later work (ROADMAP slice 3).

Not ported: ``richardson_solve`` (slice 3), GMRES (slice 8), the column
layout ``cg_solve_multi`` (slice 10), and ``cg_solve_multi_tiles`` — it
carried the Krylov state in the TPU kernel's halo-tiled layout, which the
port's K5 does not need (it reads the row layout directly).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..core import StopReason


class KrylovState(NamedTuple):
    # single-RHS: an int, a 0-d tensor and an int; lockstep multi-RHS:
    # per-RHS (k,) tensors of each
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


def cg_solve_multi_rows(matmat_rows: Callable, B: torch.Tensor, *,
                        maxiter: int = 100, tau: float = 1e-8,
                        precond: Optional[Callable] = None):
    """Lockstep multi-RHS CG in ROW layout: ``B`` is (k_rhs, n), one RHS
    per row; ``matmat_rows``/``precond`` map (k, n) -> (k, n) (e.g.
    ``lambda V: ops.bdia_spmm_rows(A, V)``, one pass over the operator for
    all rows).  Returns (X, KrylovState of per-row tensors, None).
    Semantics per row match ``cg_solve``: finished rows are frozen,
    breakdowns on u·r / p·Ap, ||r_j|| <= tau·||b_j||."""
    return _cg_lockstep(matmat_rows, B, maxiter=maxiter, tau=tau,
                        precond=precond,
                        dot=lambda a, c: torch.sum(a * c, dim=1),
                        bc=lambda s: s[:, None], n_rhs=B.shape[0])


def _cg_lockstep(matmat: Callable, B: torch.Tensor, *, maxiter: int,
                 tau: float, precond: Optional[Callable],
                 dot: Callable, bc: Callable, n_rhs: int):
    """Layout-generic lockstep CG engine: ``dot`` reduces each operand to
    a per-RHS (k,) vector, ``bc`` broadcasts per-RHS scalars back over the
    block layout.  x0 = 0.  The loop runs until no RHS is RUNNING, one
    host read per iteration."""
    M = precond or (lambda V: V)
    norm = lambda V: torch.sqrt(dot(V, V))    # noqa: E731
    codes = {r: torch.tensor(int(r), dtype=torch.int32, device=B.device)
             for r in StopReason}

    tols = tau * norm(B)
    R = B
    P = M(R)
    u_dot_r = dot(P, R)
    resid = norm(R)
    X = torch.zeros_like(B)
    k = torch.zeros(n_rhs, dtype=torch.int32, device=B.device)
    reason = torch.where(resid <= tols, codes[StopReason.CONVERGED],
                         torch.where(u_dot_r == 0, codes[StopReason.BREAKDOWN],
                                     codes[StopReason.RUNNING]))
    while bool(torch.any(reason == StopReason.RUNNING)):
        running = reason == StopReason.RUNNING
        AP = matmat(P)
        pAp = dot(P, AP)
        breakdown_pap = pAp == 0
        alpha = torch.where(running & ~breakdown_pap, u_dot_r / pAp, 0.0)
        X = X + bc(alpha) * P
        R = R - bc(alpha) * AP
        resid = torch.where(running, norm(R), resid)
        U = M(R)
        udr_new = dot(U, R)
        breakdown_udr = udr_new == 0
        beta = torch.where(running & (u_dot_r != 0), udr_new / u_dot_r, 0.0)
        # frozen rows keep their direction; running ones recur
        P = torch.where(bc(running), U + bc(beta) * P, P)
        u_dot_r = udr_new
        k = k + running.to(torch.int32)
        reason = torch.where(
            ~running, reason,
            torch.where(resid <= tols, codes[StopReason.CONVERGED],
                        torch.where(breakdown_pap | breakdown_udr,
                                    codes[StopReason.BREAKDOWN],
                                    torch.where(k >= maxiter,
                                                codes[StopReason.MAXITER],
                                                codes[StopReason.RUNNING]))))
    return X, KrylovState(k, resid, reason), None
