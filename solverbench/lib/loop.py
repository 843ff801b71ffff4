"""One run of one cell: set-up, the timed window, the check.

Set-up makes the operator (``spec.build_operator``: the benchmark's own
generator and order), the solver (``solvers/<route>.py``), the traffic
(``lib/traffic.py`` with its variation) and, for a frozen operator, the
operand (``operands/<operand>.py``), and makes the mix's warm-up solves
through the window's own call, which build the preconditioner and, in a
fresh checkout, the program's kernels; a frozen mix then freezes matrix
and preconditioner.  ``setup_s`` runs from the start of the process to the
end of set-up.

The window is a closed loop: draw the next inputs (for an operator that
changes, its new operand too), synchronise, call ``solve``, synchronise;
it starts no solve after ``seconds`` and its length runs to the end of its
last solve.  Each solve's wall time runs from its call to the synchronise
after it returns.  With ``trace`` the profiler records the window's first
solves, until ``trace_min_seconds`` have passed.

After the window the peak device memory is read, the program's state is
freed, and the configuration's reference (``reference/<check>.py``)
judges every ``check_every``-th solve (the first one drawn from the seed)
on the benchmark's own CSR of that solve's operator: ``correct`` needs
each number within the configuration's ``limits`` (the largest over the
sample of each) and no solve that failed.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from contextlib import nullcontext
from typing import List, Optional

import numpy as np

from . import spec as S
from .csr import Csr
from .trace import SOLVE, TraceSummary, Tracer

# what a number reads where no answer was judged: above every limit
NOT_JUDGED = 1e300


@dataclasses.dataclass
class Run:
    cfg: dict
    mix: dict
    A: Csr
    setup_s: float
    window_s: float
    solves: List[dict]            # {"wall_s", "iters", "success", "traced"}
    timers: dict                  # the program's setup timers, window only
    trace: Optional[TraceSummary]
    kernels: List[dict]           # kernels/*.json
    checks: dict                  # {name: {"value", "limit"}}
    memory_peak_bytes: int
    setup_parts: dict             # seconds from the start to each stage's end

    @property
    def correct(self) -> bool:
        return all(c["value"] <= c["limit"] for c in self.checks.values())

    @property
    def failed(self) -> int:
        return sum(not s["success"] for s in self.solves)


def _sync(device: str):
    if device.startswith("cuda"):
        import torch
        torch.cuda.synchronize()


def run_cell(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, dtype: Optional[str] = None,
             max_solves: Optional[int] = None,
             check_every: Optional[int] = None) -> Run:
    """One run.  ``t_start``: the process's start on ``time.perf_counter``.
    ``dtype`` (default: the configuration's), ``max_solves`` and
    ``check_every`` (default: the mix's) serve the control and the
    tests; the benchmark's runs leave them at their defaults."""
    from .traffic import Traffic
    dtype = dtype or cfg["dtype"]
    parts = {"start": time.perf_counter() - t_start}
    A = S.build_operator(cfg["operator"])
    parts["operator"] = time.perf_counter() - t_start
    solver = cfg["solver"]
    sut = S.plugin("solvers", solver["route"]).Route(solver, device, dtype)
    make_operand = S.plugin("operands", solver["operand"]).make
    judge = S.plugin("reference", cfg.get("check", "residual")).judge
    traffic = Traffic(mix, A, seed, device)
    every = check_every or mix["check_every"]
    offset = int(np.random.default_rng(seed % (1 << 63)).integers(every))

    def inputs():
        x_star, state, b = traffic.draw()
        if traffic.frozen:
            return x_star, state, b, operand
        return x_star, state, b, make_operand(traffic.host(state), dtype,
                                              device)

    operand = make_operand(A, dtype, device) if traffic.frozen else None
    parts["operand"] = time.perf_counter() - t_start
    for _ in range(mix["warmup_solves"]):
        x_star, state, b, op = inputs()
        st = sut.solve(op, b)
    if traffic.frozen:
        sut.freeze()
    tracer = Tracer(trace, device)
    tracer.warm()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    parts["warmup"] = setup_s

    reset_timers()
    solves, samples = [], []
    tracing = trace
    t0 = time.perf_counter()
    if tracing:
        tracer.start()
    while True:
        now = time.perf_counter() - t0
        if tracing and now >= mix["trace_min_seconds"]:
            tracer.stop()
            tracing = False
        if now >= seconds or (max_solves and len(solves) >= max_solves):
            break
        x_star, state, b, op = inputs()
        _sync(device)
        ts = time.perf_counter()
        with tracer.span(SOLVE) if tracing else nullcontext():
            st = sut.solve(op, b)
            _sync(device)
        wall = time.perf_counter() - ts
        k = len(solves)
        solves.append(dict(wall_s=wall, iters=int(st.iters),
                           success=bool(st.success), traced=tracing))
        if (k + offset) % every == 0:
            samples.append((st.soln, b, x_star, state))
    if tracing:
        tracer.stop()
    window_s = time.perf_counter() - t0
    timers = program_timers()

    memory_peak = 0
    if device.startswith("cuda"):
        import torch
        memory_peak = int(torch.cuda.max_memory_allocated())
    del sut, operand, op, st
    gc.collect()
    if device.startswith("cuda"):
        import torch
        torch.cuda.empty_cache()

    judged = []
    for x, b, x_star, state in samples:
        Ak = traffic.host(state)
        judged.append(judge(Ak.indptr, Ak.indices, Ak.data, b.cpu().numpy(),
                            x.cpu().numpy(), x_star.cpu().numpy()))
    checks = {f"{k}_max": {"value": max((j[k] for j in judged),
                                        default=NOT_JUDGED),
                           "limit": limit}
              for k, limit in cfg["limits"].items()}
    checks["failed_solves"] = {"value": sum(not s["success"] for s in solves),
                               "limit": 0}   # an exact count
    return Run(cfg=cfg, mix=mix, A=A, setup_s=setup_s, window_s=window_s,
               solves=solves, timers=timers, trace=tracer.reduce(),
               kernels=S.kernels(), checks=checks,
               memory_peak_bytes=memory_peak, setup_parts=parts)


def reset_timers():
    from pysolvers_tpu_torch.utils.timing import Timer
    Timer.reset()


def program_timers() -> dict:
    """The program's setup timers (host clock, summed since the reset)."""
    from pysolvers_tpu_torch.utils.timing import Timer
    return dict(Timer._totals)
