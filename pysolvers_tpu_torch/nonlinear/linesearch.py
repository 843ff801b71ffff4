"""Line searches for Newton globalization.

Port of ``pysolvers_tpu/nonlinear/linesearch.py`` (capability parity with
reference PySolvers/Nonlinear/LineSearch.py:4-81): the search protocol,
TrivialLinesearch (the full step), and SimpleBacktrack — the Dennis &
Schnabel sufficient-decrease backtracking: accept x + t·p when
||F(x+t·p)|| <= (1 − alpha·t)·||F0||, else shrink t by 0.5/ratio clamped to
[low, 0.5] (LineSearch.py:62-81).

The residuals are evaluated where the iterate lives (numpy on the host, or
a tensor on its device); the short, data-dependent backtracking loop runs
on the host and reads one norm per trial.
"""
from __future__ import annotations

import numpy as np


class LineSearchBase:
    def __init__(self, maxsteps: int = 15, alpha: float = 1e-4,
                 low: float = 0.1):
        self.maxsteps = maxsteps
        self.alpha = alpha
        self.low = low

    def search(self, x, norm_f0, p, func, norm_fn):
        """Return (x_new, F_new, norm_new, ok)."""
        raise NotImplementedError


class TrivialLinesearch(LineSearchBase):
    """Always take the full Newton step (reference LineSearch.py:40-52)."""

    def search(self, x, norm_f0, p, func, norm_fn):
        x_new = x + p
        F_new = func.evalF(x_new)
        return x_new, F_new, float(norm_fn(F_new)), True


class SimpleBacktrack(LineSearchBase):
    """Backtracking with sufficient decrease (reference LineSearch.py:55-81)."""

    def search(self, x, norm_f0, p, func, norm_fn):
        t = 1.0
        norm_f0 = float(norm_f0)
        F_new = None
        for _ in range(self.maxsteps):
            x_new = x + t * p
            F_new = func.evalF(x_new)
            norm_new = float(norm_fn(F_new))
            if np.isfinite(norm_new) and \
                    norm_new <= (1.0 - self.alpha * t) * norm_f0:
                return x_new, F_new, norm_new, True
            ratio = norm_new / norm_f0 if norm_f0 > 0 else 2.0
            shrink = 0.5 / ratio if np.isfinite(ratio) and ratio > 0 else 0.5
            t *= float(np.clip(shrink, self.low, 0.5))
        # every trial rejected: the caller stops on ok=False and reads only
        # the norm, so x is returned without evaluating F there again
        return x, F_new, norm_f0, False
