"""The plain reference of a linear solve, in NumPy alone.

A solve of A x = b with b = A x* is judged against the system itself: the
reference multiplies the benchmark's own CSR arrays of the solve's
operator by the returned x in float64 and gives

- ``resid``: ‖b − A x‖₂ / ‖b‖₂, what the solver's stopping test promises
  (≤ τ up to the drift of the recurrence), and
- ``err``: ‖x − x*‖₂ / ‖x*‖₂, against the solution the inputs were made
  from;

for a block of right-hand sides (x of shape (n, k)) the largest over its
columns.  It imports nothing of the program and takes nothing the program
made: the operator, b and x* come from the benchmark's own files.
"""
from __future__ import annotations

import numpy as np

# what a reading that is not a finite number reports (JSON has no
# infinity): above every limit
FAIL = 1e300


def csr_matvec(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
               x: np.ndarray) -> np.ndarray:
    """y = A x (x of shape (n,) or (n, k)) for a CSR matrix whose every
    row holds an entry."""
    x = x.astype(np.float64)
    d = data.astype(np.float64)
    prod = (d if x.ndim == 1 else d[:, None]) * x[indices]
    return np.add.reduceat(prod, indptr[:-1], axis=0)


def _rel(num: np.ndarray, den: np.ndarray) -> float:
    """The largest column's ‖num‖ / ‖den‖."""
    r = np.max(np.linalg.norm(num, axis=0) / np.linalg.norm(den, axis=0))
    # a NaN compares false against any limit: make it fail
    return float(r) if np.isfinite(r) else FAIL


def judge(indptr, indices, data, b, x, x_star) -> dict:
    """{"resid", "err"} of the answer ``x`` to A x = b, A the CSR."""
    x = np.asarray(x, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    x_star = np.asarray(x_star, dtype=np.float64)
    Ax = csr_matvec(indptr, indices, data, x)
    return {"resid": _rel(b - Ax, b), "err": _rel(x - x_star, x_star)}
