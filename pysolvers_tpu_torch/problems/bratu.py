"""2D Bratu nonlinear test problem.

Port of ``pysolvers_tpu/problems/bratu.py`` (capability parity with the
reference's examples/FDBratu2D.py:10-29): F(u) = A·u − alpha·exp(−u) with A
the (negative) 2D FD Laplacian, J(u) = A + alpha·diag(exp(−u)) (the
reference's sign: FDBratu2D.py:21 ``np.exp(-u)``, :27-29 adds to the
diagonal).  F and J·v run on the problem's device: on CUDA a DIA operator's
product is kernel K1, an ELL operator's the torch gather.

The Jacobian is the stored device matrix with its diagonal bumped: a clone
of the DIA table (or the ELL values) with ``alpha·exp(−u)`` added at the
diagonal's known position — the DIA row of offset 0, or the ELL slot of each
row's diagonal — so a Newton step never rebuilds the operator from the host.
The host CSR twin takes the same bump at ``_host_diag_pos``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.spmv import matvec
from ..sparse.device import DiaMatrix, EllMatrix, resolve_device
from .laplacian import fd_laplacian_2d


class Bratu2D:
    """F(u) = A u − alpha e^{−u}, J(u) = A + alpha diag(e^{−u}) on
    ``device`` (None: the current CUDA device)."""

    def __init__(self, m: int = 100, alpha: float = 0.5, fmt: str = "dia",
                 dtype=np.float64, device=None):
        if fmt not in ("dia", "ell"):
            raise ValueError(fmt)
        self.m = m
        self.n = m * m
        self.alpha = alpha
        self.fmt = fmt
        self.device = resolve_device(device)
        self.A_host = fd_laplacian_2d(m, dtype=dtype)
        # position of each diagonal entry in the host CSR data array, so the
        # host Jacobian is a vectorized diagonal bump (no reassembly)
        rows_h, cols_h, _ = self.A_host.to_coo()
        self._host_diag_pos = np.flatnonzero(rows_h == cols_h)
        if fmt == "dia":
            self.A = DiaMatrix.from_host_csr(self.A_host, device=self.device)
            self._diag_idx = self.A.offsets.index(0)
        else:
            self.A = EllMatrix.from_host_csr(self.A_host, device=self.device)
            # slot of the diagonal entry within each ELL row
            cols = self.A.cols[: self.n].cpu().numpy()
            slots = np.argmax(cols == np.arange(self.n)[:, None], axis=1)
            self._diag_slots = torch.as_tensor(slots, device=self.device)
            self._rows = torch.arange(self.n, device=self.device)

    def eval_f(self, u: torch.Tensor) -> torch.Tensor:
        return matvec(self.A, u) - self.alpha * torch.exp(-u)

    def _bumped(self, bump: torch.Tensor):
        """The device operator with ``bump`` added to its diagonal."""
        A = self.A
        if self.fmt == "dia":
            d = A.diags.clone()
            d[self._diag_idx, : self.n] += bump.to(A.dtype)
            return DiaMatrix(d, A.offsets, A.offsets_dev, A.shape)
        data = A.data.clone()
        data[self._rows, self._diag_slots] += bump.to(A.dtype)
        return EllMatrix(data, A.cols, A.shape, A.n_cols_pad)

    def eval_j(self, u: torch.Tensor):
        """The Jacobian at u as a (host CSR, device matrix) pair: the device
        matrix feeds the SpMVs, the host twin the preconditioner setup
        (formed once per solve under freeze_prec)."""
        bump = self.alpha * torch.exp(-u)
        J_host = self.A_host.copy()
        J_host.data[self._host_diag_pos] += bump.detach().cpu().numpy(
        ).astype(J_host.data.dtype)
        return J_host, self._bumped(bump)

    def eval_j_dev(self, u: torch.Tensor):
        """The device Jacobian alone (no host twin): the explicit-J path of
        ``newton_krylov_solve`` (``eval_j``)."""
        return self._bumped(self.alpha * torch.exp(-u))

    def jacobi_precond(self, J, v: torch.Tensor) -> torch.Tensor:
        """Setup-free Jacobi preconditioner from the CURRENT Jacobian
        (``newton_krylov_solve``'s ``precond_from_j``)."""
        if self.fmt == "dia":
            d = J.diags[self._diag_idx, : self.n]
        else:
            d = J.data[self._rows, self._diag_slots]
        return v / d

    # protocol used by the Newton driver (reference Newton.py:35,59)
    evalF = eval_f
    evalJ = eval_j


class Bratu2DHostOuter:
    """Newton-outer-on-host adapter around :class:`Bratu2D`.

    F and the host Jacobian run in numpy on the host, F accumulated in
    longdouble: F(u) cancels catastrophically ((1/h²)·(4u − neighbours)
    against alpha·e^{−u}), so its f64 evaluation floor, ≈ |A|·eps64 ≈ 1e-11
    at m = 100, sits at the reference's tau = 1e-12 (FDBratu2D.py:36-48);
    longdouble lowers it ≈ 1000×.  ``evalJ`` returns the host CSR and the
    device DIA Jacobian, so a mixed-precision inner solver keeps its kernel
    path.  This is the JAX package's host-outer design, kept as it is."""

    def __init__(self, prob: Bratu2D):
        if prob.fmt != "dia":
            raise ValueError("Bratu2DHostOuter needs a DIA problem")
        self.prob = prob
        self.n = prob.n
        self._data_l = prob.A_host.data.astype(np.longdouble)
        self._alpha_l = np.longdouble(prob.alpha)

    def evalF(self, u):
        # keeps extended precision when the Newton iterate carries it
        A = self.prob.A_host
        ul = np.asarray(u).astype(np.longdouble)
        prod = self._data_l * ul[A.indices]
        Au = np.add.reduceat(prod, A.indptr[:-1])
        Au[np.diff(A.indptr) == 0] = 0.0
        F_l = Au - self._alpha_l * np.exp(-ul)
        return F_l.astype(np.float64)

    def evalJ(self, u):
        p = self.prob
        bump = p.alpha * np.exp(-np.asarray(u, dtype=np.float64))
        J_host = p.A_host.copy()
        J_host.data[p._host_diag_pos] += bump.astype(J_host.data.dtype)
        return J_host, p._bumped(torch.as_tensor(bump, device=p.device))
