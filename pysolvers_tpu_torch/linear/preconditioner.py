"""Preconditioner API and matrix-free preconditioners.

Port of ``pysolvers_tpu/linear/preconditioner.py`` (reference
PySolvers/Linear/Preconditioner.py:3-68 — applyLeft/applyRight, generic /
left-only / right-only / identity variants — and the deferred factory
``PreconditionerType.form(A)``, PreconditionerType.py:4-19).

A ``Preconditioner`` is a pair of apply functions over device tensors;
``form`` runs the host setup phase and puts the state on ``device`` (the
solver passes its own; ``None`` means the current CUDA device, and raises
where there is none).

``ChebyshevPreconditionerType`` is the SpMV-only polynomial
preconditioner; its host power iteration ``estimate_lmax`` is copied
verbatim (the AMG and GMG host builders call it for their Chebyshev
smoothers).

Not ported: the ``traced`` field (it let JAX pass the state as a jit
argument).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..ops import matvec
from ..sparse.device import resolve_device
from ..sparse.host import HostCSR


@dataclasses.dataclass
class Preconditioner:
    """Two-sided apply pair.  ``None`` side means identity."""

    left: Optional[Callable] = None     # v -> M_L^{-1} v
    right: Optional[Callable] = None    # v -> M_R^{-1} v
    # generic = ONE apply usable on either side (the reference's
    # GenericPreconditioner, Preconditioner.py:20-36) — left and right
    # hold the SAME function and a solver must apply it exactly ONCE per
    # iteration, not on both sides
    generic: bool = False
    # the device state the apply functions close over (an AMG
    # DeviceHierarchy), for callers that inspect it
    state: Optional[object] = None

    def apply_left(self, v):
        return v if self.left is None else self.left(v)

    def apply_right(self, v):
        return v if self.right is None else self.right(v)

    def apply_any(self, v):
        """The single effective application, for solvers that apply M⁻¹
        once per iteration regardless of the configured side (CG's
        u = M⁻¹r).  A left-only preconditioner must not silently become
        an identity there."""
        f = self.right if self.right is not None else self.left
        return v if f is None else f(v)

    @property
    def is_identity(self):
        return self.left is None and self.right is None


class PreconditionerType:
    """Deferred factory: ``form(A_host, A_dev, device)`` → Preconditioner.

    ``A_host`` is the setup-phase matrix (HostCSR); ``A_dev`` the
    device-format matrix used by the solver (may be None for host-only
    setups that build their own device state); ``device`` is where the
    preconditioner's state lives.
    """

    side = "both"   # "left" | "right" | "both" — mirrors the reference's
                    # Left/Right/Generic preconditioner split

    def form(self, A_host: HostCSR, A_dev=None, device=None) -> Preconditioner:
        raise NotImplementedError

    def _wrap(self, apply: Callable) -> Preconditioner:
        if self.side == "left":
            return Preconditioner(left=apply)
        if self.side == "right":
            return Preconditioner(right=apply)
        return Preconditioner(left=apply, right=apply, generic=True)


class IdentityPreconditionerType(PreconditionerType):
    """Parity: reference IdentityPreconditioner (Preconditioner.py:58-68)."""

    def form(self, A_host=None, A_dev=None, device=None) -> Preconditioner:
        return Preconditioner()


class JacobiPreconditionerType(PreconditionerType):
    """M = diag(A); the classic point-Jacobi scaling."""

    def __init__(self, side: str = "right"):
        self.side = side

    def form(self, A_host: HostCSR, A_dev=None, device=None) -> Preconditioner:
        d = A_host.diagonal()
        d = np.where(d == 0, 1.0, d)
        dinv = torch.as_tensor(1.0 / d, device=resolve_device(device))
        return self._wrap(lambda v: dinv * v)


class ChebyshevPreconditionerType(PreconditionerType):
    """Chebyshev polynomial preconditioner: SpMV-only (no triangular
    solves), fixed degree.

    Approximates A^{-1} on the eigenvalue interval [lmax/eig_ratio, lmax],
    where lmax is a power-iteration estimate of the largest eigenvalue of
    D^{-1}A (host setup phase).
    """

    def __init__(self, degree: int = 3, eig_ratio: float = 30.0,
                 side: str = "right", power_iters: int = 20):
        self.degree = degree
        self.eig_ratio = eig_ratio
        self.side = side
        self.power_iters = power_iters

    def estimate_lmax(self, A_host: HostCSR) -> float:
        """Power iteration on D^{-1}A (host, setup phase)."""
        n = A_host.shape[0]
        d = A_host.diagonal()
        d = np.where(d == 0, 1.0, d)
        rng = np.random.default_rng(42)
        v = rng.random(n)
        lam = 1.0
        for _ in range(self.power_iters):
            w = A_host.matvec(v) / d
            lam = np.linalg.norm(w)
            if lam == 0:
                return 1.0
            v = w / lam
        return float(lam) * 1.05   # safety margin

    def form(self, A_host: HostCSR, A_dev=None, device=None) -> Preconditioner:
        if A_dev is None:
            raise ValueError("Chebyshev preconditioner needs the device matrix")
        lmax = self.estimate_lmax(A_host)
        lmin = lmax / self.eig_ratio
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        d = A_host.diagonal()
        d = np.where(d == 0, 1.0, d)
        dinv = torch.as_tensor(1.0 / d, device=A_dev.device)
        degree = self.degree

        def apply(r):
            # standard Chebyshev iteration for A z = r, z0 = 0,
            # preconditioned by D^{-1}
            dv = dinv.to(r.dtype)
            z = torch.zeros_like(r)
            rho_old = delta / theta
            p = dv * r / theta
            z = z + p
            rho = rho_old
            for _ in range(degree - 1):
                res = dv * (r - matvec(A_dev, z))
                rho_new = 1.0 / (2.0 * theta / delta - rho)
                p = rho_new * rho * p + (2.0 * rho_new / delta) * res
                z = z + p
                rho = rho_new
            return z

        return self._wrap(apply)
