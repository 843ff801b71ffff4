"""Mixed-precision iterative refinement: f32 inner Krylov solves on the
fast kernels, the solution and its residual in f64.

Port of ``pysolvers_tpu/linear/refine.py``: ``ir_solve`` (:33),
``_one_solve`` and ``_chained_correction`` (:129-178), the body of
``_cached_dd_chain``'s ``run`` (:255-395) as the plain function
``_dd_chain``, ``ir_solve_dd`` (:403), ``ir_solve_multi`` (:528) and
``ir_solve_host`` (:672).  The card has native f64, so the f64 oracle of a
solve is the port's own f64 operator through its kernels (K1, K2, K4/K5 or
K6 in f64), built from the f64 host data; the final check of
``ir_solve_dd`` stays an exact numpy f64 product on the host.

Every loop is a Python loop over device tensors: the JAX package's
``lax.cond``/``while_loop`` become branches on values read to the host
(one read per refinement pass or chain step, beside the inner solvers'
own).  Everything that sets iteration counts is kept: the ``chain``
passes per host check, the floor-aware inner tolerance (``f_obs``,
``tau_est``, ``gap``, ``overshoot``), ``chain = 1`` when residual
replacement or ``hi_matvec`` is on, the ``hi_matvec=None`` auto rule, the
re-scaling of each correction to O(1) and the stall, BREAKDOWN and MAXITER
rules of the host loops.

Not ported, as TPU or remote-tunnel workarounds: the jit caches
(``_INNER_CACHE``, ``_cached_inner*``, ``_cached_dd_chain``; the port runs
eagerly and compiles nothing), the traced operator/preconditioner pairs
they took (``precond_pair``, ``A_lo`` as a jit argument, ``inner_ops``),
the watchdog caps on work per dispatch and the 2× stall rule of capped
passes, the ``PST_RR``/``PST_DD_CHAIN`` switches (the port always takes
their defaults: residual replacement on, the dd route), and the emulated
f64 split-gather SpMVs (``ell_spmv_f64_splitgather``,
``ellt_spmv_f64_splitgather``).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core import StopReason
from ..ops import matvec as op_matvec
from ..sparse.device import resolve_device
from .krylov import (KrylovState, _host, cg_solve, cg_solve_rr, gmres_solve,
                     richardson_solve)

_F64 = torch.float64
_F32 = torch.float32


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v))


def _one_solve(method: str, mv, papply, r, tau, maxiter, restart,
               hi=False):
    """(correction, iterations) of one inner solve of ``method``: "cg",
    "richardson" or "gmres[:cgs2][:flex]" (GMRES options ride in the method
    string).  ``hi``: the f64 form of ``_dd_chain`` for the non-CG methods
    (FGMRES, since an f32-rounded preconditioner is not a fixed linear
    operator)."""
    if method == "cg":
        d, st, _ = cg_solve(mv, r, maxiter=maxiter, tau=tau, precond=papply)
    elif method == "richardson":
        d, st, _ = richardson_solve(mv, r, maxiter=maxiter, tau=tau,
                                    precond=papply)
    else:
        opts = method.split(":")[1:]
        d, st, _ = gmres_solve(mv, r, maxiter=maxiter, tau=tau,
                               precond=papply, restart=restart,
                               orthog="cgs2" if "cgs2" in opts else "mgs",
                               flexible=hi or "flex" in opts,
                               check_true_residual=False)
    return d, int(st.k)


def _chained_correction(method, mv, papply, r32, inner_tau, inner_maxiter,
                        restart, chain):
    """One (or ``chain`` f32-residual-chained) inner correction: each
    further solve corrects the f32 true residual of the sum so far, and is
    skipped once that residual meets ``inner_tau`` (one host read per
    step)."""
    d, k = _one_solve(method, mv, papply, r32, inner_tau, inner_maxiter,
                      restart)
    for _ in range(chain - 1):
        r2 = r32 - mv(d)
        s2, rn0 = (float(v) for v in _host(torch.stack([_norm(r2),
                                                        _norm(r32)])))
        if not s2 > np.float32(inner_tau) * np.float32(rn0):
            continue
        s2 = s2 if s2 > 0 else 1.0
        d2, k2 = _one_solve(method, mv, papply, r2 / s2, inner_tau,
                            inner_maxiter, restart)
        d = d + s2 * d2
        k += k2
    return d, k


def ir_solve(matvec_hi: Callable, matvec_lo: Callable, b: torch.Tensor, *,
             tau: float = 1e-10, max_outer: int = 20, inner_tau: float = 1e-6,
             inner_maxiter: int = 500, method: str = "cg",
             precond_lo: Optional[Callable] = None,
             restart: Optional[int] = None):
    """Solve A x = b to f64 tolerance with f32 inner solves, on b's device.

    ``matvec_hi``: f64 SpMV (true residuals); ``matvec_lo``: f32 SpMV
    (inner).  Each pass scales the residual to O(1), solves for the f32
    correction to ``inner_tau``, and adds it in f64; a pass that reduces
    the residual less than 2× is a stall (BREAKDOWN).  One host read per pass.
    Returns (x_f64, KrylovState(total inner iterations, ...), None)."""
    b = b.to(_F64)
    rn = float(_host(_norm(b)))
    tol = tau * rn
    x = torch.zeros_like(b)
    reason = StopReason.CONVERGED if rn <= tol else StopReason.RUNNING
    k = inner_total = 0
    while reason == StopReason.RUNNING:
        r = b - matvec_hi(x)
        rn_t = _norm(r)
        scale = torch.where(rn_t > 0, rn_t, 1.0)
        d32, kk = _one_solve(method, matvec_lo, precond_lo,
                             (r / scale).to(_F32), inner_tau, inner_maxiter,
                             restart)
        x = x + scale * d32.to(_F64)
        rn_old, rn = (float(v) for v in _host(torch.stack(
            [rn_t, _norm(b - matvec_hi(x))])))
        k += 1
        inner_total += kk
        if rn <= tol:
            reason = StopReason.CONVERGED
        elif k >= max_outer:
            reason = StopReason.MAXITER
        elif rn >= rn_old * 0.5:
            reason = StopReason.BREAKDOWN
    return (x, KrylovState(inner_total, torch.tensor(rn, dtype=_F64),
                           int(reason)), None)


def ir_solve_host(matvec_hi, matvec_lo, b, *, tau: float = 1e-10,
                  max_outer: int = 20, inner_tau: float = 1e-6,
                  inner_maxiter: int = 500, method: str = "cg",
                  precond_lo=None, restart=None,
                  host_residual: bool = False, A_lo=None, chain: int = 1,
                  device=None):
    """Host-driven iterative refinement: each outer pass computes the f64
    residual (on the host with ``host_residual``: ``matvec_hi`` is then a
    numpy f64 product; else on the device), and runs one f32 inner solve
    on the device.  With ``A_lo`` and while the residual is more than 1e4 ×
    the target, a pass chains ``chain`` inner corrections
    (``_chained_correction``; the JAX package's plain-callable form takes
    no chain either).

    ``A_lo``: the f32 device operator (``matvec_lo`` may then be None);
    ``device``: where the inner solve runs with ``host_residual`` (None: the
    operator's device, else the current CUDA device).  A pass that reduces
    the residual less than 2× stops: MAXITER if refinement has already
    reduced it 1e3×, else BREAKDOWN.  Returns (x, KrylovState, None), x
    a device f64 tensor."""
    if A_lo is not None:
        matvec_lo = lambda v: op_matvec(A_lo, v)        # noqa: E731
        device = A_lo.device if device is None else device
    else:
        chain = 1
    if host_residual:
        device = resolve_device(device)
        b_h = np.asarray(b, dtype=np.float64)
        x = np.zeros_like(b_h)

        def residual(xh):
            r = b_h - matvec_hi(xh)
            return r, float(np.linalg.norm(r))
        b_norm = float(np.linalg.norm(b_h))
    else:
        b_dev = b.to(_F64)
        x = torch.zeros_like(b_dev)

        def residual(xd):
            r = b_dev - matvec_hi(xd)
            return r, float(_host(_norm(r)))
        b_norm = float(_host(_norm(b_dev)))
    tol = tau * b_norm
    # chained dispatches pay off only while the residual is far from the
    # target (each chained sub-solve re-runs full inner iterations)
    chain_far = 1e4

    inner_total = 0
    rn_prev = float("inf")
    rn_first = None
    reason = StopReason.MAXITER
    for _ in range(max_outer):
        r, rn = residual(x)
        if rn_first is None:
            rn_first = rn
        if rn <= tol:
            reason = StopReason.CONVERGED
            break
        if rn >= rn_prev * 0.5:
            # the f32 inner floor: MAXITER if refinement already reduced the
            # residual substantially, BREAKDOWN for no progress at all
            reason = (StopReason.MAXITER if rn <= rn_first * 1e-3
                      else StopReason.BREAKDOWN)
            break
        rn_prev = rn
        scale = rn if rn > 0 else 1.0
        r32 = (torch.as_tensor((r / scale).astype(np.float32), device=device)
               if host_residual else (r / scale).to(_F32))
        d, kk = _chained_correction(
            method, matvec_lo, precond_lo, r32, inner_tau, inner_maxiter,
            restart, chain if rn > tol * chain_far else 1)
        inner_total += kk
        if host_residual:
            x = x + scale * _host(d).astype(np.float64)
        else:
            x = x + scale * d.to(_F64)
    else:
        _, rn = residual(x)
        if rn <= tol:
            reason = StopReason.CONVERGED
    x_out = torch.as_tensor(x, device=device) if host_residual else x
    return x_out, KrylovState(inner_total, torch.tensor(rn, dtype=_F64),
                              int(reason)), None


def _dd_chain(A_lo, papply, A64, b64, x64, tol64: float, inner_tau: float,
              f_obs: float, overshoot: float, *, method: str,
              inner_maxiter: int, restart, chain: int, first_tau: float,
              rr: bool, hi_matvec: bool, replace_every):
    """``chain`` inner corrections, each against an accurate f64 residual
    on the device (``A64``, the f64 oracle).  Returns (x64, inner
    iterations, ‖b − A₆₄x‖, f_obs).

    Floor-aware inner tolerances: a pass's true-residual reduction is
    floored near eps32·κ(A), so each pass after the first targets half the
    reduction the previous one achieved (``f_obs``), the first pass of a
    solve ``first_tau``; the internal target is ``overshoot``·tol.  With
    residual replacement (``rr``) or the f64 recurrence (``hi_matvec``) a
    pass has no floor and targets the whole remaining gap."""
    def mv(v):
        return op_matvec(A_lo, v)

    def mv_hi(v):
        return op_matvec(A64, v)

    tol_int = overshoot * tol64
    x = x64
    k_tot = 0
    rn_prev = 0.0                         # > 0 marks "previous pass ran"
    for _ in range(chain):
        r = b64 - mv_hi(x)
        rn = float(_host(_norm(r)))
        if rn_prev > 0:
            f_obs = min(max(rn / max(rn_prev, 1e-300), 0.0), 1.0)
        scale = rn if rn > 0 else 1.0
        gap = tol_int / scale
        tau_est = 0.5 * f_obs if f_obs > 0 else first_tau
        # the f32 inner tolerance, as the JAX package rounds it
        if rr or hi_matvec:
            tau_k = float(np.clip(np.float32(gap), np.float32(1e-30),
                                  np.float32(0.5)))
        else:
            tau_k = float(np.clip(np.float32(max(gap, tau_est)),
                                  np.float32(inner_tau), np.float32(0.5)))
        if not rn > tol_int:
            rn_prev = 0.0
            continue
        if rr:
            # replacement cadence: verify every 6 steps when preconditioned;
            # unpreconditioned runs go thousands of slow steps, where the
            # drop trigger still fires on fast reduction
            re_eff = (replace_every if replace_every is not None
                      else (48 if papply is None else 6))
            d64, st, _ = cg_solve_rr(mv, r / scale, mv_hi=mv_hi,
                                     maxiter=inner_maxiter, tau=tau_k,
                                     precond=papply, replace_every=re_eff,
                                     hi_matvec=hi_matvec)
            d, k = scale * d64, int(st.k)
        elif hi_matvec:
            # the non-CG methods run wholly on the f64 operator, the f32
            # preconditioner the inexact part
            papply64 = (None if papply is None else
                        (lambda v: papply(v.to(_F32)).to(_F64)))
            d64, k = _one_solve(method, mv_hi, papply64, r / scale, tau_k,
                            inner_maxiter, restart, hi=True)
            d = scale * d64
        else:
            d32, k = _one_solve(method, mv, papply, (r / scale).to(_F32),
                                tau_k, inner_maxiter, restart)
            d = scale * d32.to(_F64)
        rn_prev = rn
        x = x + d
        k_tot += k
    r = b64 - mv_hi(x)
    rn = float(_host(_norm(r)))
    if rn_prev > 0:
        f_obs = min(max(rn / max(rn_prev, 1e-300), 0.0), 1.0)
    return x, k_tot, rn, f_obs


def ir_solve_dd(mv_hi_host, b, *, A_lo, A64, tau=1e-10, inner_tau=1e-6,
                inner_maxiter=500, method="cg", precond_lo=None,
                restart=None, chain=4, max_outer=20, first_tau=1e-4,
                overshoot=0.25, hi_matvec=None, replace_every=None):
    """Host-checked refinement where each pass runs a ``chain``-step chain
    of f32 corrections against f64 residuals on the device (``_dd_chain``),
    on ``A_lo``'s device.

    ``A_lo``: the f32 operator; ``A64``: the f64 oracle (an f64 DiaMatrix,
    BwsMatrix, BdiaMatrix, GridDiaMatrix or EllMatrix built from the f64
    host data, never cast up from ``A_lo``); ``mv_hi_host``: the exact numpy
    f64 product for the host check after each pass; ``b``: numpy or
    tensor.  ``precond_lo`` applies the f32 preconditioner.
    ``first_tau``: the first pass's inner tolerance, before any reduction
    was observed (``f_obs`` rides across passes).  ``overshoot``: the
    internal target as a fraction of the user tolerance (success is judged
    against ``tau``).  ``replace_every``: the residual-replacement cadence
    (None: 6 preconditioned, 48 unpreconditioned).  ``hi_matvec``: the inner
    recurrence on the f64 operator (``cg_solve_rr(hi_matvec=True)`` for CG,
    f64 FGMRES/Richardson otherwise); None = on whenever a preconditioner
    is present.  With residual replacement (always, for CG) or
    ``hi_matvec`` one pass closes the whole gap, so ``chain`` is 1.

    A pass whose host residual and device residual both fall less than 2×
    stops: MAXITER if ‖r‖ <= 1e-3‖b‖, else BREAKDOWN.  Returns (x, KrylovState,
    None), x an f64 tensor on the device."""
    rr = method == "cg"
    if hi_matvec is None:
        hi_matvec = precond_lo is not None
    if rr or hi_matvec:
        chain = 1
    device = A_lo.device
    b_h = (b.detach().cpu().numpy() if isinstance(b, torch.Tensor)
           else np.asarray(b)).astype(np.float64)
    b_norm = float(np.linalg.norm(b_h))
    tol = tau * b_norm
    b64 = torch.as_tensor(b_h, device=device)
    x = torch.zeros_like(b64)

    inner_total = 0
    rn_prev = float("inf")
    rn = b_norm
    reason = StopReason.MAXITER
    f_obs = 0.0
    for _ in range(max(1, -(-max_outer // chain))):
        x, pass_k, rn_dev, f_obs = _dd_chain(
            A_lo, precond_lo, A64, b64, x, tol, inner_tau, f_obs, overshoot,
            method=method, inner_maxiter=inner_maxiter, restart=restart,
            chain=chain, first_tau=first_tau, rr=rr, hi_matvec=hi_matvec,
            replace_every=replace_every)
        inner_total += pass_k
        # the exact host residual
        rn = float(np.linalg.norm(b_h - mv_hi_host(_host(x))))
        if rn <= tol:
            reason = StopReason.CONVERGED
            break
        if rn >= rn_prev * 0.5 and rn_dev >= rn_prev * 0.5:
            reason = (StopReason.MAXITER if rn <= b_norm * 1e-3
                      else StopReason.BREAKDOWN)
            break
        rn_prev = rn
    return x, KrylovState(inner_total, torch.tensor(rn, dtype=_F64),
                          int(reason)), None


def ir_solve_multi(mm_hi: Callable, B64: torch.Tensor, *,
                   inner_solve: Callable, col_norm: Callable, bc: Callable,
                   tau: float = 1e-10, max_outer: int = 20,
                   inner_tau: float = 1e-6, overshoot: float = 0.25):
    """Blocked mixed-precision refinement, the lockstep analog of
    ``ir_solve_dd`` for k right-hand sides in any layout: ``col_norm(V)``
    reduces a block to per-RHS norms, ``bc(s)`` broadcasts per-RHS scalars
    back, ``mm_hi`` is the blocked f64 product.

    Each pass scales every running right-hand side's f64 residual to O(1),
    zeroes the finished ones (the lockstep inner freezes them at iteration
    0) and runs one blocked f32 inner solve, ``inner_solve(R32, tau32) ->
    (D32, per-RHS iterations)``, for all of them.  Per right-hand side:
    convergence at ‖r_j‖ <= tau‖b_j‖ on the f64 residual, a pass reducing
    it less than 2× stalls it (BREAKDOWN).  One residual block per pass
    (the JAX package computes it twice, before and after each pass).
    Returns (X64, KrylovState of per-RHS tensors, None)."""
    b_norms = col_norm(B64)
    tols = tau * b_norms
    tol_int = overshoot * tols
    tols_h = _host(tols)
    n_rhs = tols_h.shape[0]
    X = torch.zeros_like(B64)
    R = B64.clone()
    k_tot = np.zeros(n_rhs, dtype=np.int64)
    rn_prev = np.full(n_rhs, np.inf)
    stalled = np.zeros(n_rhs, dtype=bool)
    rn = col_norm(R)
    rn_h = _host(rn)
    tau32 = float(np.float32(inner_tau))
    for _ in range(max_outer):
        done_h = (rn_h <= tols_h) | stalled
        if done_h.all():
            break
        done = torch.as_tensor(done_h, device=B64.device)
        run = ~done & (rn > tol_int)
        scale = torch.where(rn > 0, rn, 1.0)
        R32 = torch.where(bc(run), R / bc(scale),
                          torch.zeros_like(R)).to(_F32)
        D32, k_arr = inner_solve(R32, tau32)
        X = X + bc(scale) * D32.to(_F64)
        k_tot += _host(k_arr).astype(np.int64) * ~done_h
        R = B64 - mm_hi(X)
        rn = col_norm(R)
        rn_h = _host(rn)
        stalled |= ~done_h & (rn_h >= rn_prev * 0.5) & (rn_h > tols_h)
        rn_prev = np.where(done_h, rn_prev, rn_h)
    conv = rn_h <= tols_h
    reason = np.where(conv, int(StopReason.CONVERGED),
                      np.where(stalled, int(StopReason.BREAKDOWN),
                               int(StopReason.MAXITER))).astype(np.int32)
    return (X, KrylovState(torch.as_tensor(k_tot.astype(np.int32)),
                           torch.as_tensor(rn_h), torch.as_tensor(reason)),
            None)
