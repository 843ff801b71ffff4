"""Solver core: configuration, result records and stop reasons.

Port of ``pysolvers_tpu/core.py`` (reference PySolvers/IterativeSolver.py:25-57
``CommonSolverArgs``, PySolvers/SolveStatus.py:8-56 ``SolveStatus``).  The
solvers are plain PyTorch loops over tensors; ``SolverConfig`` holds their
static control knobs and ``make_status`` turns a loop's final state into the
host-side ``SolveStatus``; ``host_read`` is the one device-to-host read of
the solver loops.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional

import numpy as np
import torch

from .utils.timing import Timer, traced


class StopReason(enum.IntEnum):
    """Termination codes of the solver loops."""

    RUNNING = 0
    CONVERGED = 1
    MAXITER = 2
    BREAKDOWN = 3
    TRUE_RESID_MISMATCH = 4   # GMRES implicit/true residual disagreement
    LINESEARCH_FAIL = 5
    INNER_SOLVE_FAIL = 6
    STALL = 7                 # divergence/stagnation guard tripped
                              # (best-so-far iterate returned)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static solver control knobs.

    Mirrors the reference's CommonSolverArgs (IterativeSolver.py:42-57):
    maxiter, failOnMaxiter, tau, pluggable norm, showIters/showFinal/interval.
    """

    maxiter: int = 100
    tau: float = 1.0e-8
    fail_on_maxiter: bool = True
    # norm: "2" | "inf" | "1" — pluggable norm (a callable can be passed to
    # the solver functions directly via their `norm_fn` kwarg).
    norm: str = "2"
    show_iters: bool = False
    show_final: bool = False
    interval: int = 1
    name: str = ""

    def norm_fn(self) -> Callable:
        if self.norm == "2":
            return lambda v: torch.sqrt(torch.sum(v * v))
        if self.norm == "inf":
            return lambda v: torch.max(torch.abs(v))
        if self.norm == "1":
            return lambda v: torch.sum(torch.abs(v))
        raise ValueError(f"unknown norm {self.norm!r}")

    def replace(self, **kw) -> "SolverConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class SolveStatus:
    """Uniform solve result (host-side record).

    Parity with reference SolveStatus.py:8-56: success flag, solution,
    final residual norm, iteration count, message, plus the stop reason
    code and the per-iteration residual history.
    """

    success: bool
    soln: object
    resid: float
    iters: int
    reason: StopReason = StopReason.CONVERGED
    msg: str = ""
    resid_history: Optional[np.ndarray] = None

    def __bool__(self):
        return bool(self.success)

    def __str__(self):
        s = "succeeded" if self.success else f"FAILED ({self.reason.name})"
        return (f"SolveStatus: {s} after {self.iters} iterations, "
                f"final resid={self.resid:.3e}. {self.msg}")


def host_read(t: torch.Tensor):
    """``t`` read to the host: a Python scalar where ``t`` is 0-d
    (``item``), else a numpy array; one sync where ``t`` lies on the card.
    Every call adds one to the counter "host_reads" (``Timer.calls``) and,
    while the profiler runs, is the span "krylov.host_read", the host's
    wait for the card.  The Krylov solvers' reads (``linear/krylov.py``:
    ``_host``, the stop reason, the lockstep test) and ``make_status``'s
    go through it."""
    Timer.count("host_reads")
    with traced("krylov.host_read"):
        return t.item() if t.dim() == 0 else t.cpu().numpy()


def make_status(x, state, config: SolverConfig, as_preconditioner: bool = False,
                history=None, live_reported: bool = False) -> SolveStatus:
    """Build a host SolveStatus from a solver loop's final state.

    ``state`` must expose .k (iterations), .resid (residual norm) and
    .reason (StopReason code).  Reproduces the reference's handleMaxiter
    rule: hitting maxiter counts as success when fail_on_maxiter is False
    (used for AMG-as-preconditioner; IterativeSolver.py:117-129).

    Host reads (``host_read``): ``state.resid`` and ``history``, each where
    it is a tensor (two after ``cg_solve``).
    """
    reason = StopReason(int(state.reason))
    if reason == StopReason.MAXITER and (not config.fail_on_maxiter or as_preconditioner):
        success = True
        msg = "maxiter reached (accepted: fail_on_maxiter=False)"
    elif reason == StopReason.CONVERGED:
        success = True
        msg = ""
    else:
        success = False
        msg = f"stopped: {reason.name}"
    if isinstance(history, torch.Tensor):
        history = host_read(history)
    resid = state.resid
    if isinstance(resid, torch.Tensor):
        resid = host_read(resid)
    st = SolveStatus(
        success=success,
        soln=x,
        resid=float(resid),
        iters=int(state.k),
        reason=reason,
        msg=msg,
        resid_history=np.asarray(history) if history is not None else None,
    )
    if config.show_final:
        print(st)
    if config.show_iters and not live_reported and st.resid_history is not None:
        r0 = st.resid_history[0] if len(st.resid_history) else 1.0
        for i in range(0, st.iters + 1):
            if i % max(config.interval, 1) == 0 and i < len(st.resid_history):
                r = st.resid_history[i]
                print(f"  iter={i:6d}  ||r||={r:12.5e}  ||r||/r0={r / max(r0, 1e-300):12.5e}")
    return st
