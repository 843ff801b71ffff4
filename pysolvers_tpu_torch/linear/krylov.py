"""Krylov solvers: preconditioned CG (single- and multi-RHS) and GMRES(m).

Port of ``cg_solve``, ``cg_solve_multi_rows``, ``_cg_lockstep`` and
``gmres_solve`` in ``pysolvers_tpu/linear/krylov.py`` (reference
PySolvers/Linear/PCGSolver.py:64-145: right-preconditioned CG with
breakdown checks on u·r and p·Ap, convergence on ||r|| <= tau*||b||,
trivial-b shortcut; GMRESSolver.py:27-180: right-preconditioned GMRES with
the true-residual recheck).

The JAX ``lax.while_loop`` becomes a Python loop that reads the stop
reason back to the host once per iteration (one device sync each; the
lockstep solver reads whether any right-hand side is still running).
GMRES reads the new Hessenberg column instead and runs the Givens
rotations and the back substitution on the host in the solve's dtype (on
the device they would be O(k) launches of 0-d ops per iteration).
Capturing the iteration in a CUDA graph, and checking the reason less
often, is later work (ROADMAP slice 3).

Not ported: ``richardson_solve`` (slice 3), the column layout
``cg_solve_multi`` and ``gmres_solve_multi`` (slice 10), and
``cg_solve_multi_tiles`` — it carried the Krylov state in the TPU kernel's
halo-tiled layout, which the port's K5 does not need (it reads the row
layout directly).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
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


# ---------------------------------------------------------------------------
# GMRES(m) with restarts
# ---------------------------------------------------------------------------

_RESTART = -1     # cycle full but not done (the JAX loop's sentinel)


def _host(t: torch.Tensor) -> np.ndarray:
    """The device-to-host read of a GMRES iteration (the new Hessenberg
    column, one sync); tests count its calls."""
    return t.cpu().numpy()


def gmres_solve(matvec: Callable, b: torch.Tensor,
                x0: Optional[torch.Tensor] = None, *, maxiter: int = 100,
                restart: Optional[int] = None, tau: float = 1e-8,
                precond: Optional[Callable] = None,
                norm_fn: Optional[Callable] = None,
                check_true_residual: bool = True, orthog: str = "mgs",
                iter_callback: Optional[Callable] = None,
                flexible: bool = False):
    """Right-preconditioned GMRES(m).  Returns (x, KrylovState, history).

    The reference runs full GMRES with m = maxiter and no restart
    (GMRESSolver.py:77-83); ``restart`` gives GMRES(m), m =
    min(restart or maxiter, maxiter).  On stopping the solution is formed
    and the true residual recomputed; a CONVERGED solve whose true
    residual exceeds 10·tau·||b|| becomes TRUE_RESID_MISMATCH
    (GMRESSolver.py:159-174).  ``history`` (a CPU tensor) holds the
    residual norm of every iteration, the true one at each cycle start.

    ``orthog``: "mgs" — modified Gram-Schmidt, k+1 dot/axpy pairs on the
    device at step k (GMRESSolver.py:110-112); "cgs2" — classical
    Gram-Schmidt with one reorthogonalization, two matrix-vector product
    pairs against the k+1 live rows of Q (the JAX package multiplies all
    m+1 rows, whose rest are zero).

    ``flexible=True`` → FGMRES (Saad 1993): z_k = M⁻¹ q_k is stored in Z
    and x = x0 + Z y, so the preconditioner may vary between applies.

    Q (m+1, n) (and Z (m, n)) are allocated on b's device once per solve.
    Each iteration reads one (k+2)-vector to the host: the new Hessenberg
    column, whose rotations, the stop test and ``iter_callback(total,
    resid)`` run there.
    """
    if orthog not in ("mgs", "cgs2"):
        raise ValueError(f"orthog must be 'mgs' or 'cgs2', got {orthog!r}")
    if maxiter < 1:
        raise ValueError(f"GMRES needs maxiter >= 1, got {maxiter}")
    norm = norm_fn or (lambda v: torch.sqrt(_dot(v, v)))
    M = precond or (lambda v: v)
    if x0 is None:
        x0 = torch.zeros_like(b)
    n = b.shape[0]
    m = min(restart or maxiter, maxiter)
    dtype, device = b.dtype, b.device
    np_dt = np.dtype(str(dtype).split(".")[1])
    # host scalars in the solve's dtype (Python floats are IEEE doubles)
    scal = float if np_dt == np.float64 else np_dt.type
    hypot = math.hypot if np_dt == np.float64 else np.hypot

    b_norm_t = norm(b)
    b_norm = scal(_host(b_norm_t))
    tol = scal(tau) * b_norm

    Q = torch.zeros((m + 1, n), dtype=dtype, device=device)
    Z = torch.zeros((m, n), dtype=dtype, device=device) if flexible else None
    H = np.zeros((m + 1, m), dtype=np_dt)
    g = [scal(0)] * (m + 1)
    cs = [(scal(1), scal(0))] * m
    history = np.full(maxiter + 1, np.nan, dtype=np_dt)

    def start_cycle(x, total):
        r = b - matvec(x)
        beta_t = norm(r)
        beta = scal(_host(beta_t))
        if beta > 0:
            torch.div(r, beta_t, out=Q[0])
        else:
            Q[0].copy_(r)
        H.fill(0)
        g[:] = [scal(0)] * (m + 1)
        g[0] = beta
        history[total] = beta
        return (StopReason.CONVERGED if beta <= tol
                else StopReason.RUNNING)

    def form_solution(x, k):
        """Back substitution on the k×k triangle (host), then the basis
        combination on the device."""
        if k == 0:
            return x
        y = np.zeros(k, dtype=np_dt)
        for j in range(k - 1, -1, -1):
            s = g[j] - H[j, j + 1:k] @ y[j + 1:]
            y[j] = s / H[j, j] if H[j, j] != 0 else s
        y_t = torch.as_tensor(y, device=device)
        if flexible:
            return x + y_t @ Z[:k]
        return x + M(y_t @ Q[:k])

    x, total, k = x0, 0, 0
    reason = start_cycle(x, total)
    while True:
        while reason == StopReason.RUNNING:
            zk = M(Q[k])
            if flexible:
                Z[k] = zk
            u = matvec(zk)
            if orthog == "cgs2":
                Qa = Q[: k + 1]
                h1 = Qa @ u
                u = u - h1 @ Qa
                h2 = Qa @ u
                u = u - h2 @ Qa
                hs = [h1 + h2]
            else:
                hs = []
                for j in range(k + 1):
                    hj = torch.dot(Q[j], u)
                    # the first update allocates: u may alias Q[k]
                    u = (torch.addcmul(u, Q[j], hj, value=-1.0) if j == 0
                         else u.addcmul_(Q[j], hj, value=-1.0))
                    hs.append(hj.reshape(1))
            hk1_t = norm(u)
            torch.div(u, hk1_t, out=Q[k + 1])
            h = _host(torch.cat(hs + [hk1_t.reshape(1)]))
            h = h.tolist() if scal is float else list(h)
            lucky = h[k + 1] == 0
            if lucky:
                Q[k + 1].copy_(u)
            # the earlier rotations, then a new one zeroing h[k+1]
            for j in range(k):
                c, s = cs[j]
                hj, hj1 = h[j], h[j + 1]
                h[j] = c * hj + s * hj1
                h[j + 1] = -s * hj + c * hj1
            r = scal(hypot(h[k], h[k + 1]))
            ck, sk = ((h[k] / r, h[k + 1] / r) if r > 0
                      else (scal(1), scal(0)))
            cs[k] = (ck, sk)
            h[k] = ck * h[k] + sk * h[k + 1]
            h[k + 1] = scal(0)
            gk, gk1 = g[k], g[k + 1]
            g[k] = ck * gk + sk * gk1
            g[k + 1] = -sk * gk + ck * gk1
            H[: k + 2, k] = h
            resid = abs(g[k + 1])
            k += 1
            total += 1
            history[total] = resid
            if iter_callback is not None:
                iter_callback(total, resid)
            if resid <= tol or lucky:
                reason = StopReason.CONVERGED
            elif total >= maxiter:
                reason = StopReason.MAXITER
            elif k >= m:
                reason = _RESTART
        if reason != _RESTART:
            break
        x = form_solution(x, k)
        k = 0
        reason = start_cycle(x, total)

    x = form_solution(x, k)
    true_resid = norm(b - matvec(x))
    if (check_true_residual and reason == StopReason.CONVERGED
            and b_norm > 0 and scal(_host(true_resid)) > 10.0 * tol):
        reason = StopReason.TRUE_RESID_MISMATCH
    return (x, KrylovState(total, true_resid, int(reason)),
            torch.from_numpy(history))
