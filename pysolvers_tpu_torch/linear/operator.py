"""Operator algebra: compose, add, scale and invert linear operators.

Port of ``pysolvers_tpu/linear/operator.py`` (the working version of the
reference's unexported Linear/LinearOperator.py, SURVEY §7.3).  Operators
are closures over tensors; ``inverse`` solves at apply time, with
unpreconditioned GMRES or a solver factory (the reference's InverseOp
intent, LinearOperator.py:105-119).  Nothing is left out.
"""
from __future__ import annotations

from typing import Callable, Optional

from ..core import StopReason
from ..ops import matvec as _matvec


class LinearOperator:
    """A shape-carrying matvec closure with operator algebra.

    Build from a matrix (``LinearOperator.from_matrix``) or a function.
    Supports ``A + B``, ``A - B``, ``c * A``, ``A @ B`` (composition),
    ``A.T`` (if a transpose closure is given) and ``A.inverse(solver_type)``.
    """

    def __init__(self, shape, apply_fn: Callable,
                 transpose_fn: Optional[Callable] = None):
        self.shape = tuple(shape)
        self._apply = apply_fn
        self._transpose = transpose_fn

    # ---- construction ----

    @staticmethod
    def from_matrix(A_dev, shape=None) -> "LinearOperator":
        shape = shape or A_dev.shape
        return LinearOperator(shape, lambda v: _matvec(A_dev, v))

    @staticmethod
    def identity(n: int) -> "LinearOperator":
        return LinearOperator((n, n), lambda v: v, lambda v: v)

    # ---- application ----

    def __call__(self, v):
        return self._apply(v)

    def matvec(self, v):
        return self._apply(v)

    # ---- algebra ----

    def __add__(self, other: "LinearOperator") -> "LinearOperator":
        if self.shape != other.shape:
            raise ValueError(f"shape mismatch {self.shape} vs {other.shape}")
        return LinearOperator(
            self.shape, lambda v: self._apply(v) + other._apply(v))

    def __sub__(self, other: "LinearOperator") -> "LinearOperator":
        if self.shape != other.shape:
            raise ValueError(f"shape mismatch {self.shape} vs {other.shape}")
        return LinearOperator(
            self.shape, lambda v: self._apply(v) - other._apply(v))

    def __mul__(self, c) -> "LinearOperator":
        if isinstance(c, LinearOperator):
            raise TypeError("use A @ B for operator composition; * is "
                            "scalar scaling only")
        return LinearOperator(self.shape, lambda v: c * self._apply(v))

    __rmul__ = __mul__

    def __neg__(self) -> "LinearOperator":
        return self * (-1.0)

    def __matmul__(self, other: "LinearOperator") -> "LinearOperator":
        if self.shape[1] != other.shape[0]:
            raise ValueError(f"compose mismatch {self.shape} @ {other.shape}")
        return LinearOperator(
            (self.shape[0], other.shape[1]),
            lambda v: self._apply(other._apply(v)))

    @property
    def T(self) -> "LinearOperator":
        if self._transpose is None:
            raise NotImplementedError("no transpose closure provided")
        return LinearOperator((self.shape[1], self.shape[0]),
                              self._transpose, self._apply)

    # ---- inversion ----

    def inverse(self, solver_type=None) -> "LinearOperator":
        """Operator that solves ``self @ x = v`` on application.

        Takes a LinearSolverType factory (``api.GMRES(...)``, its
        ``device`` the one of the vectors it will get); the default is
        unpreconditioned GMRES (maxiter 200, tau 1e-12) on the vector's
        device.  An apply whose solve fails raises.
        """
        if self.shape[0] != self.shape[1]:
            raise ValueError("inverse of non-square operator")
        from .krylov import gmres_solve

        if solver_type is None:
            def apply_inv(v):
                x, st, _ = gmres_solve(self._apply, v, maxiter=200,
                                       tau=1e-12)
                if st.reason != StopReason.CONVERGED:
                    raise RuntimeError(
                        f"inverse apply failed: GMRES stopped with "
                        f"{StopReason(st.reason).name} at residual "
                        f"{float(st.resid):.3e}")
                return x
            return LinearOperator(self.shape, apply_inv)

        def apply_inv(v):
            st = solver_type.make_solver().solve(_FnMatrix(self), v)
            if not st.success:
                raise RuntimeError(f"inverse apply failed: {st}")
            return st.soln

        return LinearOperator(self.shape, apply_inv)


class _FnMatrix:
    """Adapter so the api solvers can take a LinearOperator as a matrix."""

    def __init__(self, op: LinearOperator):
        self.op = op
        self.shape = op.shape
        self.ndim = 2

    def __matmul__(self, v):
        return self.op(v)
