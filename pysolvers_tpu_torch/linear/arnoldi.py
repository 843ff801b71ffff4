"""Standalone Arnoldi factorizations and Givens utilities.

Port of ``pysolvers_tpu/linear/arnoldi.py`` (reference
Linear/ArnoldiGS.py:11-83 — classical and modified Gram-Schmidt Arnoldi
building A·Q_k = Q_{k+1}·H̄; Linear/Givens.py:7-34 — rotation find and
apply), as plain functions on tensors.  The GMRES loop in ``krylov.py``
runs its own recurrences; these serve testing, teaching and spectral
estimation.  The JAX ``fori_loop``s become Python loops, and the masked
full-width MGS loop runs over the k + 1 live rows only (the masked rows add
exact zeros).
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch


def givens_coefficients(a, b):
    """(c, s) of the rotation zeroing b in [a; b] (reference Givens.py:7-12).
    hypot, not sqrt(a*a+b*b): the squared form overflows f32 at
    |a| ~ 1.8e19 and silently zeroes the rotation."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    r = torch.hypot(a, b)
    safe = r > 0
    r1 = torch.where(safe, r, torch.ones_like(r))
    c = torch.where(safe, a / r1, torch.ones_like(r))
    s = torch.where(safe, b / r1, torch.zeros_like(r))
    return c, s


def apply_givens(v, c, s, i, j):
    """Rotate entries (i, j) of v (reference Givens.py:16-24); returns a new
    tensor."""
    vi, vj = v[i], v[j]
    out = v.clone()
    out[i] = c * vi + s * vj
    out[j] = -s * vi + c * vj
    return out


def arnoldi(matvec: Callable, q0: torch.Tensor, m: int,
            method: str = "mgs") -> Tuple[torch.Tensor, torch.Tensor]:
    """Run m Arnoldi steps from q0 (normalized here).

    Returns (Q, H): Q (m+1, n) with orthonormal rows and H (m+1, m) upper
    Hessenberg with A Q[k] = Σ_j H[j, k] Q[j].  ``method``: "mgs"
    (modified GS, reference ArnoldiGS.py:52-83) or "cgs" (classical GS,
    ArnoldiGS.py:11-50).  A zero new direction (breakdown) leaves a zero
    row in Q, as in the JAX package.
    """
    if method not in ("mgs", "cgs"):
        raise ValueError(f"unknown Arnoldi method {method!r}")
    n = q0.shape[0]
    dtype, device = q0.dtype, q0.device
    Q = torch.zeros((m + 1, n), dtype=dtype, device=device)
    Q[0] = q0 / torch.linalg.vector_norm(q0)
    H = torch.zeros((m + 1, m), dtype=dtype, device=device)
    for k in range(m):
        u = matvec(Q[k])
        if method == "cgs":
            h = Q[: k + 1] @ u
            u = u - h @ Q[: k + 1]
            H[: k + 1, k] = h
        else:
            for j in range(k + 1):
                hj = torch.dot(Q[j], u)
                u = u - hj * Q[j]
                H[j, k] = hj
        beta = torch.linalg.vector_norm(u)
        H[k + 1, k] = beta
        Q[k + 1] = torch.where(beta > 0,
                               u / torch.where(beta > 0, beta, 1.0),
                               torch.zeros_like(u))
    return Q, H


def arnoldi_residual(matvec: Callable, Q: torch.Tensor, H: torch.Tensor):
    """‖A Q_m − Q_{m+1} H̄‖_F and ‖QQᵀ − I‖_F (the reference's self-test
    metrics, ArnoldiGS.py:98-133)."""
    m = H.shape[1]
    AQ = torch.stack([matvec(q) for q in Q[:m]])      # (m, n)
    recon = H.T @ Q                                    # (m, n)
    fact_err = torch.linalg.norm(AQ - recon)
    orth_err = torch.linalg.norm(
        Q @ Q.T - torch.eye(Q.shape[0], dtype=Q.dtype, device=Q.device))
    return fact_err, orth_err
