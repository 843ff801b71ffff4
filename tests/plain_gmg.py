"""A plain reference of PCG preconditioned by geometric multigrid on the
5-point operator of −div(a∇u), in plain ``torch`` and float64.

It imports neither JAX nor any module of ``pysolvers_tpu_torch``, and holds
no kernel, cache or table layout: every operator is a ``torch.sparse``
COO matrix and every product ``torch.sparse.mm``.  It runs on any device
(the CPU in the tests, the card for the full-size check).

The grid: m × m interior vertices of the unit square, h = 1/(m + 1),
homogeneous Dirichlet conditions, unknown (i, j) at ((i + 1)h, (j + 1)h),
row i·m + j.  The coefficient a is given per cell, an (m + 1) × (m + 1)
array (cell (p, q) spans vertices p..p+1 by q..q+1, counting the boundary
vertices); a ≡ 1 is the Poisson case, PySolvers ``FDLaplacian2D``'s
(1/h²)·(4, −1, −1, −1, −1).

Multigrid as Briggs, Henson & McCormick, *A Multigrid Tutorial* (2nd ed.,
SIAM 2000), ch. 3 and 5, on the vertex-centred grids m_c = (m − 1)/2:

- prolongation: bilinear interpolation, the tensor product of the 1-D map
  v_{2c+1} = v^c_c, v_{2c} = (v^c_{c−1} + v^c_c)/2 (zero outside), ch. 3;
- restriction: full weighting, (1/16)·[1 2 1; 2 4 2; 1 2 1], which is
  (1/4)·Pᵀ in two dimensions, ch. 3.  The port forms it as the
  row-normalised Pᵀ; every coarse vertex's column of P sums to 4 (its nine
  fine neighbours are all interior), so the two are the same matrix, and
  the scaling needs no departure;
- coarse operators: the Galerkin product R·A·P, formed explicitly (ch. 5),
  where the textbook's own coarse operator is the rediscretised one;
- V-cycle: ν₁ Jacobi sweeps x ← x + ω·D⁻¹(f − Ax), ω = 2/3, the residual,
  its restriction, the coarse correction from zero, its prolongation, ν₂
  sweeps; on the coarsest level a dense solve.  The port applies the
  coarsest level's dense inverse instead, which agrees to rounding;
- the apply: ``num_iters`` V-cycles from x = 0;
- PCG: Hestenes and Stiefel's preconditioned CG from x = 0, stopping when
  ‖r‖₂ ≤ τ‖b‖₂.
"""
from __future__ import annotations

import torch

# the reference's products must not run in TF32 on a GPU
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F64 = torch.float64


def _coo(rows, cols, vals, shape):
    return torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, shape,
                                   check_invariants=False).coalesce()


def operator(m: int, a: torch.Tensor = None, device="cpu") -> torch.Tensor:
    """The 5-point matrix of −div(a∇u) on the m × m interior grid.

    An edge's coefficient is the mean of the two cells beside it; row
    (i, j) holds Σ a_e / h² on the diagonal and −a_e / h² towards each
    interior neighbour (a boundary neighbour's term stays on the
    diagonal)."""
    h2 = (1.0 / (m + 1)) ** 2
    if a is None:
        a = torch.ones((m + 1, m + 1), dtype=F64, device=device)
    a = a.to(device=device, dtype=F64)
    ex = 0.5 * (a[:, :-1] + a[:, 1:])   # [I, j]: vertices (I, j)-(I+1, j)
    ey = 0.5 * (a[:-1, :] + a[1:, :])   # [i, J]: vertices (i, J)-(i, J+1)
    diag = (ex[:-1, :] + ex[1:, :] + ey[:, :-1] + ey[:, 1:]) / h2
    g = torch.arange(m * m, device=device).reshape(m, m)
    rows, cols, vals = [g.reshape(-1)], [g.reshape(-1)], [diag.reshape(-1)]
    # (i, j)–(i+1, j): the edge ex[i+1, j]
    down = (-ex[1:-1, :] / h2).reshape(-1)
    rows += [g[:-1, :].reshape(-1), g[1:, :].reshape(-1)]
    cols += [g[1:, :].reshape(-1), g[:-1, :].reshape(-1)]
    vals += [down, down]
    # (i, j)–(i, j+1): the edge ey[i, j+1]
    right = (-ey[:, 1:-1] / h2).reshape(-1)
    rows += [g[:, :-1].reshape(-1), g[:, 1:].reshape(-1)]
    cols += [g[:, 1:].reshape(-1), g[:, :-1].reshape(-1)]
    vals += [right, right]
    n = m * m
    return _coo(torch.cat(rows), torch.cat(cols), torch.cat(vals), (n, n))


def _interp_1d(m_f: int, device):
    """Rows, columns and weights of 1-D linear interpolation from m_c =
    (m_f − 1)/2 coarse to m_f fine interior points."""
    m_c = (m_f - 1) // 2
    c = torch.arange(m_c, device=device)
    rows = torch.cat([2 * c + 1, 2 * c, 2 * c + 2])
    cols = torch.cat([c, c, c])
    vals = torch.cat([torch.ones(m_c, dtype=F64, device=device),
                      torch.full((2 * m_c,), 0.5, dtype=F64, device=device)])
    return rows, cols, vals, m_c


def prolongation(m_f: int, device="cpu") -> torch.Tensor:
    """Bilinear interpolation, (m_f², m_c²): the tensor product of the
    1-D map with itself in the row order i·m + j."""
    r1, c1, v1, m_c = _interp_1d(m_f, device)
    rows = (r1[:, None] * m_f + r1[None, :]).reshape(-1)
    cols = (c1[:, None] * m_c + c1[None, :]).reshape(-1)
    vals = (v1[:, None] * v1[None, :]).reshape(-1)
    return _coo(rows, cols, vals, (m_f * m_f, m_c * m_c))


def restriction(P: torch.Tensor) -> torch.Tensor:
    """Full weighting: (1/4)·Pᵀ."""
    return (0.25 * P.t()).coalesce()


def hierarchy(A: torch.Tensor, m: int, num_levels: int) -> list:
    """[(A_k, 1/diag(A_k), m_k, P_k, R_k)], fine first; P_k and R_k move
    between level k and level k + 1 (None on the coarsest)."""
    levels = []
    for k in range(num_levels):
        d = torch.zeros(A.shape[0], dtype=F64, device=A.device)
        idx = A.indices()
        on = idx[0] == idx[1]
        d[idx[0][on]] = A.values()[on]
        if k == num_levels - 1:
            levels.append((A, 1.0 / d, m, None, None))
            break
        P = prolongation(m, A.device)
        R = restriction(P)
        levels.append((A, 1.0 / d, m, P, R))
        A = torch.sparse.mm(R, torch.sparse.mm(A, P)).coalesce()
        m = (m - 1) // 2
    return levels


def _mv(A, x):
    return torch.sparse.mm(A, x[:, None])[:, 0]


def v_cycle(levels, f, x, nu1=2, nu2=2, omega=2.0 / 3.0, k=0):
    A, dinv, _, P, R = levels[k]
    if P is None:
        return torch.linalg.solve(A.to_dense(), f)
    for _ in range(nu1):
        x = x + omega * dinv * (f - _mv(A, x))
    f_c = _mv(R, f - _mv(A, x))
    x_c = v_cycle(levels, f_c, torch.zeros_like(f_c), nu1, nu2, omega, k + 1)
    x = x + _mv(P, x_c)
    for _ in range(nu2):
        x = x + omega * dinv * (f - _mv(A, x))
    return x


def apply(levels, r, num_iters=2, nu1=2, nu2=2):
    """``num_iters`` V-cycles from zero: the preconditioner's M⁻¹ r."""
    x = torch.zeros_like(r)
    for _ in range(num_iters):
        x = v_cycle(levels, r, x, nu1, nu2)
    return x


def pcg(A, b, precond, tau=1e-10, maxiter=200):
    """(x, iterations): preconditioned CG from x = 0 until
    ‖r‖₂ ≤ τ‖b‖₂."""
    x = torch.zeros_like(b)
    r = b.clone()
    tol = tau * torch.linalg.vector_norm(b)
    z = precond(r)
    p = z.clone()
    rz = torch.dot(r, z)
    for k in range(1, maxiter + 1):
        Ap = _mv(A, p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        if torch.linalg.vector_norm(r) <= tol:
            return x, k
        z = precond(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x, maxiter
