"""Krylov solvers: preconditioned CG (single- and multi-RHS), GMRES(m)
(single- and multi-RHS), Richardson, and CG with f64 residual replacement.

Port of ``richardson_solve``, ``cg_solve``, ``cg_solve_multi``,
``cg_solve_multi_rows``, ``_cg_lockstep``, ``cg_lockstep_rr``,
``cg_solve_rr``, ``gmres_solve`` and ``gmres_solve_multi`` in
``pysolvers_tpu/linear/krylov.py`` (reference
PySolvers/Linear/PCGSolver.py:64-145: right-preconditioned CG with
breakdown checks on u·r and p·Ap, convergence on ||r|| <= tau*||b||,
trivial-b shortcut; GMRESSolver.py:27-180: right-preconditioned GMRES with
the true-residual recheck; VCycleSolver.py:79-91: the stationary
iteration).

The JAX ``lax.while_loop`` becomes a Python loop that reads the stop
reason back to the host once per iteration (one device sync each; the
lockstep solver reads whether any right-hand side is still running).
GMRES reads the new Hessenberg column instead and runs the Givens
rotations and the back substitution on the host in the solve's dtype (on
the device they would be O(k) launches of 0-d ops per iteration).  The
residual-replacement solvers turn the JAX ``lax.cond`` on a replacement
into a Python branch: ``cg_solve_rr`` reads one packed vector per
iteration (the recurrence norm, p·Ap and the previous u·r) and a second
one on an iteration that replaces; ``cg_lockstep_rr`` reads one pair of
flags per iteration.  Every such read goes through ``_host``, which tests
count.  Capturing the iteration in a CUDA graph, and checking the reason
less often, is later work (ROADMAP slice 3).

The column-layout multi-RHS solvers read the host once per iteration as
well: ``cg_solve_multi`` is the lockstep engine with per-column dots, and
``gmres_solve_multi`` reads the new Hessenberg columns of all right-hand
sides and rotates them on the host, as ``gmres_solve`` does for one.

Not ported: ``cg_solve_multi_tiles`` — it carried the Krylov state in the
TPU kernel's halo-tiled layout, which the port's K5 does not need (it
reads the row layout directly; ``cg_lockstep_rr`` runs on that layout
too).
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


def _host(t: torch.Tensor) -> np.ndarray:
    """A device-to-host read of a solver iteration (one sync: GMRES's new
    Hessenberg column, the packed scalars of the replacement solvers);
    tests count its calls."""
    return t.cpu().numpy()


def _stop_reason(converged, breakdown, k: int, maxiter: int) -> int:
    """CONVERGED > BREAKDOWN > MAXITER > RUNNING, as the JAX loop orders
    them; the one host read of the iteration."""
    last = StopReason.MAXITER if k >= maxiter else StopReason.RUNNING
    code = torch.where(converged, int(StopReason.CONVERGED),
                       torch.where(breakdown, int(StopReason.BREAKDOWN),
                                   int(last)))
    return int(code)


def richardson_solve(matvec: Callable, b: torch.Tensor,
                     x0: Optional[torch.Tensor] = None, *,
                     maxiter: int = 100, tau: float = 1e-8,
                     precond: Optional[Callable] = None,
                     norm_fn: Optional[Callable] = None):
    """Preconditioned stationary (Richardson) iteration:
    x_{k+1} = x_k + M(b - A x_k), stop on ||r|| <= tau ||b||.

    With M = one AMG V-cycle this is the reference's V-cycle-as-solver
    (VCycleSolver.py:79-91).  One host read per iteration.  Returns (x,
    KrylovState, None) like the Krylov drivers."""
    norm = norm_fn or (lambda v: torch.sqrt(_dot(v, v)))
    M = precond or (lambda v: v)
    tol = tau * norm(b)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    rn = norm(r)
    k = 0
    reason = (StopReason.CONVERGED if _host(rn <= tol)
              else StopReason.RUNNING)
    while reason == StopReason.RUNNING:
        x = x + M(r)
        r = b - matvec(x)
        rn = norm(r)
        k += 1
        if _host(rn <= tol):
            reason = StopReason.CONVERGED
        elif k >= maxiter:
            reason = StopReason.MAXITER
    return x, KrylovState(k, rn, int(reason)), None


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


def cg_solve_multi(matmat: Callable, B: torch.Tensor,
                   X0: Optional[torch.Tensor] = None, *, maxiter: int = 100,
                   tau: float = 1e-8, precond: Optional[Callable] = None):
    """Blocked multi-RHS preconditioned CG in COLUMN layout: the k columns
    of ``B`` (n, k) advance in lockstep, one operator pass for all of them
    per iteration (``matmat`` maps (n, k) -> (n, k), e.g.
    ``lambda V: ops.matmat(A, V)``).  Returns (X, KrylovState of per-column
    tensors, None).  Per column the semantics of ``cg_solve``: finished
    columns are frozen, breakdowns on u·r / p·Ap, ||r_j|| <= tau·||b_j||.
    ``precond`` maps an (n, k) block to its columns' applies."""
    return _cg_lockstep(matmat, B, maxiter=maxiter, tau=tau, precond=precond,
                        dot=lambda a, c: torch.sum(a * c, dim=0),
                        bc=lambda s: s[None, :], n_rhs=B.shape[1], X0=X0)


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
                 dot: Callable, bc: Callable, n_rhs: int,
                 X0: Optional[torch.Tensor] = None):
    """Layout-generic lockstep CG engine: ``dot`` reduces each operand to
    a per-RHS (k,) vector, ``bc`` broadcasts per-RHS scalars back over the
    block layout.  x0 = ``X0`` (None: zero).  The loop runs until no RHS
    is RUNNING, one host read per iteration."""
    M = precond or (lambda V: V)
    norm = lambda V: torch.sqrt(dot(V, V))    # noqa: E731
    codes = {r: torch.tensor(int(r), dtype=torch.int32, device=B.device)
             for r in StopReason}

    tols = tau * norm(B)
    R = B if X0 is None else B - matmat(X0)
    P = M(R)
    u_dot_r = dot(P, R)
    resid = norm(R)
    X = torch.zeros_like(B) if X0 is None else X0
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
# CG with f64 residual replacement (the mixed-precision inner solvers)
# ---------------------------------------------------------------------------

def _dot64(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f64 reduction of a·c: both operands cast to f64 before the product
    (the JAX package's hi-dots order; a dot of f32 operands accumulated in
    f64 would round each product in f32 first)."""
    a64 = a.to(torch.float64)
    return torch.dot(a64, a64 if c is a else c.to(torch.float64))


def cg_lockstep_rr(matmat: Callable, B_hi: torch.Tensor, *, mm_hi: Callable,
                   maxiter: int = 100, tau: float = 1e-8,
                   precond: Optional[Callable] = None,
                   replace_every: int = 48, replace_drop: float = 3e-4,
                   min_claim_gap: int = 4, dot: Optional[Callable] = None,
                   bc: Optional[Callable] = None,
                   n_rhs: Optional[int] = None):
    """Lockstep multi-RHS CG with periodic f64 residual replacement — the
    blocked analog of ``cg_solve_rr``: one continuous f32 pass for all k
    right-hand sides to f64-grade tolerances.

    ``B_hi`` is the f64 block, by default in ROW layout (k, n) with
    ``dot``/``bc`` reducing each row and broadcasting per-row scalars (pass
    others for another layout); ``matmat``/``precond`` map the f32 block to
    itself (e.g. kernel K5, ``ops.bdia_spmm_rows``), ``mm_hi`` the f64 block
    (the f64 oracle).  The recurrence residual block is replaced by the
    true block B_hi − A₆₄·X₆₄ every ``replace_every`` steps, or, at least
    ``min_claim_gap`` steps after the last replacement, when a row's
    recurrence norm reaches its tolerance or drops below ``replace_drop``
    times its value at the last replacement; the search directions carry
    on.  Dots are f64 (hi-dots, ``cg_solve_rr``).  Convergence is declared
    only on replaced (true) residuals; a row whose replaced residual comes
    back 16× worse than its best freezes with StopReason.STALL.

    One host read per iteration: whether any row still runs and whether a
    row claims, packed.  The read comes before the iteration commits, so
    the loop ends after one uncommitted operator product.  Returns (X64,
    KrylovState of per-row tensors — the residuals at the last
    replacement — , None)."""
    f64 = torch.float64
    dot = dot or (lambda a, c: torch.sum(a * c, dim=1))
    bc = bc or (lambda s: s[:, None])
    n_rhs = B_hi.shape[0] if n_rhs is None else n_rhs
    M = precond or (lambda V: V)
    dot64 = lambda a, c: dot(a.to(f64), c.to(f64))      # noqa: E731
    norm = lambda V: torch.sqrt(dot64(V, V))            # noqa: E731
    dev = B_hi.device
    codes = {r: torch.tensor(int(r), dtype=torch.int32, device=dev)
             for r in StopReason}

    tols = tau * norm(B_hi)
    R = B_hi.to(torch.float32)
    U = M(R)
    udr = dot64(U, R)
    resid = norm(R)
    P = U
    X64 = torch.zeros(B_hi.shape, dtype=f64, device=dev)
    resid_true, best_true, anchor = resid, resid, resid
    k = torch.zeros(n_rhs, dtype=torch.int32, device=dev)
    reason = torch.where(resid <= tols, codes[StopReason.CONVERGED],
                         torch.where(udr == 0, codes[StopReason.BREAKDOWN],
                                     codes[StopReason.RUNNING]))
    it = last_rep = 0
    while True:
        running = reason == StopReason.RUNNING
        AP = matmat(P)
        pAp = dot64(P, AP)
        breakdown_pap = running & (pAp == 0)
        alpha = torch.where(running & ~breakdown_pap, udr / pAp, 0.0)
        R_rec = torch.addcmul(R, AP, bc(alpha.to(R.dtype)), value=-1.0)
        resid = torch.where(running, norm(R_rec), resid)
        claim = running & (resid <= tols)
        dropt = running & (resid <= replace_drop * anchor)
        go, flag = _host(torch.stack([torch.any(running),
                                      torch.any(claim | dropt)]))
        if not go:
            break
        X64.addcmul_(P.to(f64), bc(alpha).to(f64))
        R = R_rec
        it += 1
        gap = it - last_rep
        conv = stalled = torch.zeros_like(running)
        if gap >= replace_every or (flag and gap >= min_claim_gap):
            Rt64 = B_hi - mm_hi(X64)
            rt = norm(Rt64)
            R = torch.where(bc(running), Rt64.to(R.dtype), R)
            conv = running & (rt <= tols)
            stalled = running & claim & (rt > 16.0 * best_true)
            resid_true = torch.where(running, rt, resid_true)
            best_true = torch.minimum(best_true, torch.where(
                running, rt, torch.full_like(rt, float("inf"))))
            anchor = torch.where(running, rt, anchor)
            last_rep = it
            del Rt64
        resid = torch.where(running & conv, resid_true, resid)
        U = M(R)
        udr_new = dot64(U, R)
        breakdown_udr = running & (udr_new == 0) & ~conv
        beta = torch.where(running & (udr != 0), udr_new / udr, 0.0)
        P = torch.where(bc(running),
                        torch.addcmul(U, P, bc(beta.to(U.dtype))), P)
        udr = udr_new
        k = k + running.to(torch.int32)
        reason = torch.where(
            ~running, reason,
            torch.where(conv, codes[StopReason.CONVERGED],
                        torch.where(stalled, codes[StopReason.STALL],
                                    torch.where(breakdown_pap | breakdown_udr,
                                                codes[StopReason.BREAKDOWN],
                                                torch.where(
                                                    k >= maxiter,
                                                    codes[StopReason.MAXITER],
                                                    codes[StopReason.RUNNING]
                                                )))))
    return X64, KrylovState(k, resid_true, reason), None


def cg_solve_rr(matvec: Callable, b_hi: torch.Tensor, *, mv_hi: Callable,
                maxiter: int = 100, tau: float = 1e-8,
                precond: Optional[Callable] = None,
                replace_every: int = 6, replace_drop: float = 3e-4,
                hi_dots: bool = True, hi_matvec: bool = False,
                norm_fn: Optional[Callable] = None):
    """Preconditioned CG with periodic f64 residual replacement (Van der
    Vorst & Ye 2000).

    An f32 CG's true residual stalls at ~eps32·κ(A): the recurrence
    residual drifts from b − A·x.  Here the recurrence residual is replaced
    by the true residual b_hi − A₆₄·x₆₄ (``mv_hi``, the f64 oracle, against
    the f64-accumulated x) whenever ``replace_every`` steps have passed,
    when the recurrence norm reaches the tolerance, or when the last
    residual fell below ``replace_drop`` times its value at the last
    replacement; the search direction carries on, so the method converges
    like f64 CG at f32 kernel speed.

    The vector updates are ``addcmul``s, rounded once like the fused
    multiply-adds XLA makes of the JAX package's expressions (and one
    kernel each on the card instead of two).  ``matvec``/``precond`` run in f32, ``mv_hi`` in f64; ``b_hi`` is the
    f64 right-hand side.  Convergence is declared only on replaced (true)
    residuals.  A replacement more than 4× larger than the previous
    residual restarts the direction (p = u).  The best replaced iterate is
    kept; a replacement more than 16× above it, or a non-finite residual,
    stops with StopReason.STALL and returns that iterate (NaN-proof: the
    comparison is negated).  ``hi_dots``: dots and norms reduce the f32
    values cast to f64.  ``hi_matvec``: the recurrence runs in f64 on
    ``mv_hi``, only the preconditioner in f32.

    Host reads (``_host``): one per iteration — the recurrence norm, p·Ap
    and the previous iteration's u·r, packed — and a second on an iteration
    that replaces (the true norm); a stop on MAXITER or STALL reads the
    last u·r once more, since a zero there makes it BREAKDOWN.  A zero u·r
    found at the next iteration's read ends the solve before that
    iteration commits, as the JAX loop's stop would.  The host compares in
    the norm's dtype.  The best iterate is copied only on a replacement
    that improves it.  Returns ``(x64, KrylovState, None)``.
    """
    f64 = torch.float64
    dot = _dot64 if hi_dots else _dot
    norm = norm_fn or (lambda v: torch.sqrt(dot(v, v)))
    M = precond or (lambda v: v)
    # working dtype of the recurrence vectors (r, p): f64 when the
    # recurrence matvec runs hi, f32 otherwise
    wt = f64 if hi_matvec else torch.float32
    mv_rec = mv_hi if hi_matvec else matvec
    if hi_matvec:
        M_rec = ((lambda v: M(v.to(torch.float32)).to(f64))
                 if precond is not None else (lambda v: v))
    else:
        M_rec = M
    r = b_hi.to(wt)                       # x0 = 0
    b_norm = norm(r)
    u = M_rec(r)
    udr = dot(u, r)
    p = u

    def read(*ts):
        return _host(torch.stack([t.to(f64) for t in ts]))

    scal = np.dtype(str(b_norm.dtype).split(".")[1]).type
    h = read(b_norm, tau * b_norm, udr)
    resid, tol = scal(h[0]), scal(h[1])
    anchor, r_best = resid, float(resid)
    x64 = torch.zeros_like(b_hi, dtype=f64)
    x_best = None                        # zeros until a replacement is best
    k = 0
    reason = (StopReason.CONVERGED if resid <= tol else
              StopReason.BREAKDOWN if h[2] == 0 else StopReason.RUNNING)
    while reason == StopReason.RUNNING:
        Ap = mv_rec(p)
        pAp = dot(p, Ap)
        alpha = torch.where(pAp == 0, 0.0, udr / pAp)
        r_rec = torch.addcmul(r, Ap, alpha.to(wt), value=-1.0)
        rn_rec_t = norm(r_rec)
        h = read(rn_rec_t, pAp, udr)
        if h[2] == 0:
            # the previous iteration's u·r was zero: the JAX loop stopped
            # there with BREAKDOWN, before this iteration
            reason = StopReason.BREAKDOWN
            break
        breakdown_pap = h[1] == 0
        rn_rec = scal(h[0])
        x64.addcmul_(p.to(f64), alpha.to(f64))
        k += 1
        do_replace = (k % replace_every == 0 or rn_rec <= tol
                      or resid <= scal(replace_drop) * anchor)
        if do_replace:
            r = (b_hi - mv_hi(x64)).to(wt)
            resid_new = scal(read(norm(r))[0])
        else:
            r, resid_new = r_rec, rn_rec
        del r_rec
        restart_dir = do_replace and resid_new > 4.0 * resid
        # NaN-proof: a NaN residual fails every comparison
        diverged = ((do_replace and not float(resid_new) <= 16.0 * r_best)
                    or not np.isfinite(resid_new))
        if do_replace:
            anchor = resid_new
            if resid_new < r_best:
                x_best, r_best = x64.clone(), float(resid_new)
        resid = resid_new
        if do_replace and resid <= tol:
            reason = StopReason.CONVERGED
            break
        if breakdown_pap:
            reason = StopReason.BREAKDOWN
            break
        u = M_rec(r)
        udr_new = dot(u, r)
        beta = (torch.zeros_like(udr_new) if restart_dir else
                torch.where(udr == 0, 0.0, udr_new / udr))
        p = torch.addcmul(u, p, beta.to(wt))
        udr = udr_new
        if k >= maxiter or diverged:
            # u·r = 0 outranks MAXITER and STALL, as in the JAX loop
            reason = (StopReason.BREAKDOWN if read(udr)[0] == 0 else
                      StopReason.MAXITER if k >= maxiter else
                      StopReason.STALL)
    # a non-converged exit takes the best replaced iterate when the final
    # state is worse (NaN-proof: not (resid <= r_best))
    take_best = (reason != StopReason.CONVERGED
                 and not float(resid) <= r_best)
    if take_best:
        x_out = torch.zeros_like(x64) if x_best is None else x_best
        r_out = r_best
    else:
        x_out, r_out = x64, float(resid)
    return (x_out, KrylovState(k, torch.tensor(r_out, dtype=f64),
                               int(reason)), None)


# ---------------------------------------------------------------------------
# GMRES(m) with restarts
# ---------------------------------------------------------------------------

_RESTART = -1     # cycle full but not done (the JAX loop's sentinel)


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


def gmres_solve_multi(matmat: Callable, B: torch.Tensor, *,
                      maxiter: int = 100, tau: float = 1e-8,
                      precond: Optional[Callable] = None,
                      restart: Optional[int] = None):
    """Blocked multi-RHS right-preconditioned GMRES: the k columns of ``B``
    (n, k) run independent Arnoldi recurrences in lockstep, one operator
    pass (``matmat``, (n, k) -> (n, k)) and one preconditioner apply
    (``precond``, the same) for all of them per step.  Returns (X,
    KrylovState of per-column CPU tensors, None): iterations, true residual
    norms and stop reasons.

    The JAX package's semantics (``gmres_solve_multi``): MGS on the device
    for all columns at once; a column that converges (or breaks down
    luckily) freezes its Hessenberg, Givens and right-hand-side state and
    writes zero basis vectors, so it drops out of the solution.  A cycle
    ends when no column runs or after m = min(restart or maxiter, maxiter)
    steps; then every column takes its correction, its TRUE residual
    B − A·X is computed, and columns above tau·||b_j|| with budget left run
    another cycle from their residual (a shared basis reset) — an
    optimistic implicit residual reactivates its column instead of ending
    it.

    One host read per step: the new Hessenberg columns; the rotations, the
    stop tests and the back substitution run on the host in B's dtype.  One
    read per cycle of the residual norms (and an upload of the step
    weights, and of the active columns when they change).
    """
    M = precond or (lambda V: V)
    n, kr = B.shape
    m = maxiter if restart is None else max(1, min(int(restart), maxiter))
    dtype, device = B.dtype, B.device
    np_dt = np.dtype(str(dtype).split(".")[1])
    cnorm = lambda V: torch.sqrt(torch.sum(V * V, dim=0))  # noqa: E731
    RUN, CONV = int(StopReason.RUNNING), int(StopReason.CONVERGED)
    MAXIT = int(StopReason.MAXITER)

    bn = cnorm(B)
    b_norms, tols = _host(torch.stack([bn, tau * bn]))
    Q = torch.zeros((m + 1, n, kr), dtype=dtype, device=device)
    X = torch.zeros_like(B)
    R = B
    total = np.zeros(kr, dtype=np.int64)
    resid = b_norms
    reason = np.where(b_norms <= tols, CONV, RUN)
    while (reason == RUN).any():
        # one lockstep Arnoldi cycle from the per-column residuals R
        beta_t = cnorm(R)
        beta = _host(beta_t)
        torch.div(R, torch.where(beta_t > 0, beta_t, 1.0), out=Q[0])
        H = np.zeros((m + 1, m, kr), dtype=np_dt)
        g = np.zeros((m + 1, kr), dtype=np_dt)
        g[0] = beta
        cs = np.zeros((m, 2, kr), dtype=np_dt)
        # columns already done enter frozen; CONVERGED is the in-cycle
        # freeze code — the outer loop sets the final reasons
        cyc = np.where((reason == RUN) & (beta > tols), RUN, CONV)
        k_col = np.zeros(kr, dtype=np.int64)
        active = cyc == RUN
        active_t = torch.as_tensor(active, device=device)
        k = 0
        while (cyc == RUN).any() and k < m:
            if not np.array_equal(active, cyc == RUN):
                active = cyc == RUN
                active_t = torch.as_tensor(active, device=device)
            U = matmat(M(Q[k]))
            hs = []
            for j in range(k + 1):
                hj = torch.sum(Q[j] * U, dim=0)
                U = torch.addcmul(U, Q[j], hj[None, :], value=-1.0)
                hs.append(hj)
            hk1 = cnorm(U)
            hs.append(hk1)
            # frozen columns write zero basis vectors (their own recurrence
            # could overflow, and 0·NaN would poison the solution)
            torch.where(active_t[None, :],
                        U / torch.where(hk1 == 0, 1.0, hk1)[None, :],
                        torch.zeros((), dtype=dtype, device=device),
                        out=Q[k + 1])
            h = _host(torch.stack(hs))                    # (k+2, kr)
            lucky = h[k + 1] == 0
            for j in range(k):            # the earlier rotations
                c, s_ = cs[j, 0], cs[j, 1]
                h[j], h[j + 1] = c * h[j] + s_ * h[j + 1], \
                    -s_ * h[j] + c * h[j + 1]
            r = np.hypot(h[k], h[k + 1])
            safe = r > 0
            rs = np.where(safe, r, np_dt.type(1))
            ck = np.where(safe, h[k] / rs, np_dt.type(1))
            sk = np.where(safe, h[k + 1] / rs, np_dt.type(0))
            h[k] = ck * h[k] + sk * h[k + 1]
            h[k + 1] = 0
            gk = ck * g[k] + sk * g[k + 1]
            gk1 = -sk * g[k] + ck * g[k + 1]
            a = active
            H[: k + 2, k, a] = h[:, a]
            g[k, a], g[k + 1, a] = gk[a], gk1[a]
            cs[k, 0, a], cs[k, 1, a] = ck[a], sk[a]
            k += 1
            k_col[a] = k
            res = np.abs(gk1)
            cyc = np.where(~a, cyc,
                           np.where((res <= tols) | lucky, CONV,
                                    np.where(k >= m, MAXIT, RUN)))
        # per-column back substitution on the triangularized H (columns
        # that took no step get y = 0), then X += M(Q y)
        y = np.zeros((k, kr), dtype=np_dt)
        for j in range(k - 1, -1, -1):
            s_ = g[j] - np.sum(H[j, :k] * y, axis=0)
            hjj = H[j, j]
            y[j] = np.where(j < k_col, s_ / np.where(hjj != 0, hjj, 1), 0)
        Z = torch.einsum("knc,kc->nc", Q[:k],
                         torch.as_tensor(y, device=device))
        X = X + M(Z)
        R = B - matmat(X)
        resid = _host(cnorm(R))
        total += k_col
        reason = np.where(resid <= tols, CONV,
                          np.where(total >= maxiter, MAXIT, RUN))
    return (X, KrylovState(torch.as_tensor(total.astype(np.int32)),
                           torch.as_tensor(resid),
                           torch.as_tensor(reason.astype(np.int32))), None)
