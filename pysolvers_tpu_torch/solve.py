"""One-call convenience front end: ``pysolvers_tpu_torch.solve(A, b)``.

Port of the native-precision CG route of ``pysolvers_tpu/solve.py``.
Picks a method and preconditioner from the matrix's structure:

* symmetric (within tolerance) → PCG, else GMRES;
* small systems (n <= 500) → direct dense solve;
* preconditioner "auto": AMG for large SPD systems, IC(t) for medium SPD,
  ILUT for nonsymmetric.

Only the CG route with ``"none"``, ``"amg"`` and ``"jacobi"`` (and
``"auto"`` where it resolves to AMG) runs in this slice.  The others raise
``NotImplementedError`` naming their ROADMAP slice: GMRES, the direct
solve, IC(t)/ILUT (slice 8), ``precision="mixed"`` (slice 7), the
block-DIA lane and multi-RHS solves (slice 10) and ``mesh=`` (slice 12).
None of them falls through to another route.
"""
from __future__ import annotations

import numpy as np

from .api import CommonSolverArgs, PCG
from .core import SolveStatus
from .linear.amg import AMGPreconditionerType
from .linear.preconditioner import JacobiPreconditionerType
from .sparse.host import HostCSR


def _is_symmetric(A: HostCSR, rtol: float = 1e-10) -> bool:
    At = A.transpose()
    if A.nnz != At.nnz:
        return False
    if not (np.array_equal(A.indptr, At.indptr)
            and np.array_equal(A.indices, At.indices)):
        return False
    denom = np.abs(A.data).max() if A.nnz else 1.0
    return float(np.abs(A.data - At.data).max()) <= rtol * max(denom, 1e-300)


def _detect_block_size(A: HostCSR, candidates=(8, 7, 6, 5, 4, 3, 2),
                       max_boffs: int = 32, min_density: float = 0.7):
    """Largest candidate b for which ``A`` has genuine b×b block-DIA
    structure, or None.  Copied from
    ``pysolvers_tpu/sparse/bdia.py::detect_block_size``: the JAX front end
    reroutes such matrices to its block-DIA lane, which the port refuses
    until that lane is ported (ROADMAP slice 10)."""
    n, m = A.shape
    if n != m or A.nnz == 0:
        return None
    rows, cols, _ = A.to_coo()
    for b in candidates:
        if n % b:
            continue
        boffs = np.unique(cols // b - rows // b)
        if len(boffs) > max_boffs:
            continue
        if A.nnz >= min_density * len(boffs) * b * b * (n // b):
            return b
    return None


_PRECONDS = ("auto", "none", "ic", "ilut", "amg", "jacobi")


def _precond_type(precond: str, method: str, n: int):
    """Resolve a precond name to a PreconditionerType (or None).  Unknown
    names raise — a typo must not silently run unpreconditioned."""
    if precond not in _PRECONDS:
        raise ValueError(f"unknown precond {precond!r}; "
                         f"expected one of {_PRECONDS}")
    if precond == "auto":
        if method == "cg":
            precond = "amg" if n >= 20_000 else "ic"
        else:
            precond = "ilut"
    if precond == "none":
        return None
    if precond in ("ic", "ilut"):
        raise NotImplementedError(f"precond={precond!r} is not ported yet "
                                  "(ROADMAP slice 8)")
    if precond == "amg":
        return AMGPreconditionerType(num_iters=2, num_levels=2)
    return JacobiPreconditionerType()


def solve(A, b, *, tau: float = 1e-8, maxiter: int = 1000,
          method: str = "auto", precond: str = "auto",
          precision: str = "native", detect_blocks: bool = True,
          device=None, **solver_kwargs) -> SolveStatus:
    """Solve A x = b on ``device`` (None: ``torch.get_default_device()``).
    Returns a SolveStatus whose ``soln`` is a tensor on that device.

    ``A``: a HostCSR or a dense 2-D ndarray; ``b``: (n,).
    ``method``: "auto" | "cg" | "gmres" | "direct".
    ``precond``: "auto" | "none" | "ic" | "ilut" | "amg" | "jacobi".
    ``precision``: "native" solves in the matrix dtype ("mixed" is not
    ported yet).  ``detect_blocks``: an all-"auto" CG call on a large
    block-structured matrix would take the block-DIA lane, which is not
    ported yet; pass False to force the scalar route.
    """
    if isinstance(A, np.ndarray) and A.ndim == 2:
        A = HostCSR.from_dense(A)
    if not isinstance(A, HostCSR):
        raise TypeError("solve() takes a HostCSR or a dense ndarray; use "
                        "the factory API for device formats")
    if "mesh" in solver_kwargs:
        raise NotImplementedError("mesh= is not ported yet (ROADMAP slice 12)")
    if solver_kwargs:
        raise TypeError(f"unexpected arguments {sorted(solver_kwargs)}")
    n = A.shape[0]
    b = np.asarray(b)

    if precision == "mixed":
        raise NotImplementedError("precision='mixed' is not ported yet "
                                  "(ROADMAP slice 7)")
    if precision != "native":
        raise ValueError(f"precision must be 'native' or 'mixed', "
                         f"got {precision!r}")
    if method == "auto":
        if n <= 500:
            method = "direct"
        else:
            method = "cg" if _is_symmetric(A) else "gmres"

    if (detect_blocks and method == "cg" and precond == "auto"
            and n >= 10_000 and _detect_block_size(A) is not None):
        raise NotImplementedError("block-structured matrices take the "
                                  "block-DIA lane, which is not ported yet "
                                  "(ROADMAP slice 10); pass "
                                  "detect_blocks=False for the scalar route")
    if b.ndim == 2:
        raise NotImplementedError("multi-RHS solves are not ported yet "
                                  "(ROADMAP slice 10)")
    if b.ndim != 1:
        raise ValueError(f"solve() takes b of shape (n,); got {b.shape}")

    if method in ("direct", "gmres"):
        raise NotImplementedError(f"method={method!r} is not ported yet "
                                  "(ROADMAP slice 8)")
    if method != "cg":
        raise ValueError(f"unknown method {method!r}")

    prec_type = _precond_type(precond, method, n)
    control = CommonSolverArgs(maxiter=maxiter, tau=tau)
    return PCG(control, precond=prec_type, device=device
               ).make_solver().solve(A, b)
