"""A plain reference of PCG preconditioned by per-field smoothed-aggregation
multigrid on a system of b coupled fields, in plain ``torch`` and float64.

It imports neither JAX nor any module of ``pysolvers_tpu_torch``, and holds
no kernel, cache or planar layout: every operator is a ``torch.sparse`` COO
matrix in node-major order (unknown i·b + p is field p at grid node i) and
every product ``torch.sparse.mm``.  It runs on any device (the CPU in the
tests, the card for the full-size check).

The system: PySolvers ``examples/FDLaplacian2D.py``'s 5-point negative
Laplacian L = (1/h²)·(4, −1, −1, −1, −1) on an m × m interior grid of the
unit square (h = 1/(m + 1), homogeneous Dirichlet conditions, rows
lexicographic), with b fields at every node coupled by a b × b matrix C:
A[i·b + p, j·b + q] = L[i, j]·C[p, q], so that every stencil offset holds a
dense b × b block.  The vector Laplacian takes C = I + c·(1 − I), which is
SPD for |c|·(b − 1) < 1.

The preconditioner treats each field on its own, the coupling between
fields left to CG: one scalar smoothed-aggregation hierarchy per field,
built from that field's block A[p::b, p::b] and applied to that field's
unknowns alone (the "unknown" approach to systems of PDEs of hypre's
BoomerAMG).  Each coarsening, as PySolvers ``Linear/SmoothedAggregation.py``
describes it:

- strength (:41-55): the off-diagonal a_ij is strong where
  |a_ij| ≥ tol·√(|a_ii|·|a_jj|) (a zero diagonal read as 1), with
  tol = 0.08·0.5^(level − 1) on the level made by the level-th coarsening
  (:62-63);
- aggregation (:57-143), three greedy phases over the nodes in order, each
  node's strong neighbours in column order: (1) a node whose strong
  neighbours are all free starts an aggregate with them; (2) a free node
  joins the aggregate of its first aggregated strong neighbour; (3) a node
  still free is an aggregate of its own;
- the tentative prolongator P̂ (:145-155): P̂[i, agg(i)] = 1;
- the filtered matrix A_f (:157-183): the weak off-diagonal entries
  dropped and added to their row's diagonal;
- the prolongator (:185-205): P = P̂ − ω·D_f⁻¹·A_f·P̂, ω = 2/3, D_f the
  diagonal of A_f (a zero read as 1);
- the restriction R = Pᵀ and the Galerkin coarse operator R·A·P.

A hierarchy stops where a level has 8 unknowns or fewer, or where a
coarsening leaves as many as it had.  One apply is ``num_iters`` V-cycles
from zero per field: ν₁ weighted-Jacobi sweeps x ← x + ω·D⁻¹(f − Ax),
ω = 2/3, the residual, its restriction, the coarse correction from zero,
its prolongation, ν₂ sweeps, and on the coarsest level a dense solve.  PCG
is Hestenes and Stiefel's preconditioned CG from x = 0, stopping when
‖r‖₂ ≤ τ‖b‖₂.

Departures from PySolvers, each the port's own choice, which this file
checks and does not judge:

- R = Pᵀ where PySolvers row-normalises Pᵀ (``MLHierarchy.py:60-78``): on
  aggregates of uneven size the normalised R makes R·A·P unsymmetric;
- the smoother is weighted Jacobi where PySolvers defaults to Gauss-Seidel
  (``ClassicSmoothers.py:20-36``);
- phase 3 makes every node still free an aggregate of its own, where
  PySolvers' guard of that phase is inverted (:135), a bug;
- the coarsest solve is ``torch.linalg.solve`` on the dense matrix where
  PySolvers factors the sparse one; the port applies the dense inverse
  instead, which agrees to rounding.

The aggregation walks each node's neighbours in Python, on lists read back
from the matrix's device.
"""
from __future__ import annotations

import torch

# the reference's products must not run in TF32 on a GPU
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F64 = torch.float64
OMEGA = 2.0 / 3.0


def _coo(rows, cols, vals, shape):
    return torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, shape,
                                   check_invariants=False).coalesce()


def laplacian(m: int, device="cpu") -> torch.Tensor:
    """The 5-point negative Laplacian (1/h²)·(4, −1, −1, −1, −1) on the
    m × m interior grid, row i·m + j."""
    h = 1.0 / (m + 1)
    s = 1.0 / (h * h)
    g = torch.arange(m * m, device=device).reshape(m, m)
    rows, cols = [g.reshape(-1)], [g.reshape(-1)]
    vals = [torch.full((m * m,), 4.0 * s, dtype=F64, device=device)]
    for a, b in ((g[:-1, :], g[1:, :]), (g[:, :-1], g[:, 1:])):
        a, b = a.reshape(-1), b.reshape(-1)
        rows += [a, b]
        cols += [b, a]
        vals += [torch.full((2 * a.numel(),), -s, dtype=F64, device=device)]
    return _coo(torch.cat(rows), torch.cat(cols), torch.cat(vals),
                (m * m, m * m))


def coupling_matrix(b: int, c: float) -> torch.Tensor:
    """C = I + c·(1 − I): every field coupled to every other by c."""
    eye = torch.eye(b, dtype=F64)
    return eye + c * (torch.ones((b, b), dtype=F64) - eye)


def block_operator(m: int, C: torch.Tensor, device="cpu") -> torch.Tensor:
    """A[i·b + p, j·b + q] = L[i, j]·C[p, q], node-major."""
    L = laplacian(m, device)
    b = C.shape[0]
    C = C.to(device=device, dtype=F64)
    r, c = L.indices()
    p = torch.arange(b, device=device)
    rows = (r[:, None, None] * b + p[None, :, None]).expand(-1, b, b)
    cols = (c[:, None, None] * b + p[None, None, :]).expand(-1, b, b)
    vals = L.values()[:, None, None] * C[None, :, :]
    n = m * m * b
    return _coo(rows.reshape(-1), cols.reshape(-1), vals.reshape(-1), (n, n))


def field(A: torch.Tensor, p: int, b: int) -> torch.Tensor:
    """Field p's own block A[p::b, p::b]."""
    r, c = A.indices()
    keep = (r % b == p) & (c % b == p)
    n = A.shape[0] // b
    return _coo(r[keep] // b, c[keep] // b, A.values()[keep], (n, n))


def diagonal(A: torch.Tensor) -> torch.Tensor:
    r, c = A.indices()
    on = r == c
    d = torch.zeros(A.shape[0], dtype=A.dtype, device=A.device)
    d[r[on]] = A.values()[on]
    return d


def _nonzero(d):
    return torch.where(d == 0, torch.ones_like(d), d)


def strength(A: torch.Tensor, tol: float) -> torch.Tensor:
    """Per stored entry: |a_ij| ≥ tol·√(|a_ii|·|a_jj|)."""
    r, c = A.indices()
    d = _nonzero(diagonal(A).abs())
    return A.values().abs() >= tol * torch.sqrt(d[r] * d[c])


def aggregates(A: torch.Tensor, strong: torch.Tensor) -> torch.Tensor:
    """The aggregate of every node, by the three greedy phases."""
    n = A.shape[0]
    r, c = A.indices()
    keep = strong & (r != c)
    neighbours = [[] for _ in range(n)]
    # coalesced: row-major, columns ascending within a row
    for i, j in zip(r[keep].tolist(), c[keep].tolist()):
        neighbours[i].append(j)
    agg = [-1] * n
    count = 0
    for i in range(n):
        if agg[i] == -1 and all(agg[j] == -1 for j in neighbours[i]):
            agg[i] = count
            for j in neighbours[i]:
                agg[j] = count
            count += 1
    for i in range(n):
        if agg[i] == -1:
            for j in neighbours[i]:
                if agg[j] != -1:
                    agg[i] = agg[j]
                    break
    for i in range(n):
        if agg[i] == -1:
            agg[i] = count
            count += 1
    return torch.tensor(agg, dtype=torch.int64, device=A.device)


def tentative(agg: torch.Tensor) -> torch.Tensor:
    n, n_agg = agg.numel(), int(agg.max()) + 1
    return _coo(torch.arange(n, device=agg.device), agg,
                torch.ones(n, dtype=F64, device=agg.device), (n, n_agg))


def filtered(A: torch.Tensor, strong: torch.Tensor) -> torch.Tensor:
    """A with its weak off-diagonal entries added to their row's diagonal
    and dropped."""
    r, c = A.indices()
    v = A.values()
    weak = ~strong & (r != c)
    lump = torch.zeros(A.shape[0], dtype=v.dtype, device=v.device)
    lump.index_add_(0, r[weak], v[weak])
    keep = ~weak
    r, c, v = r[keep], c[keep], v[keep].clone()
    on = r == c
    v[on] = v[on] + lump[r[on]]
    return _coo(r, c, v, A.shape)


def prolongator(A: torch.Tensor, agg: torch.Tensor,
                strong: torch.Tensor) -> torch.Tensor:
    """P = P̂ − ω·D_f⁻¹·A_f·P̂."""
    P_hat = tentative(agg)
    A_f = filtered(A, strong)
    r, c = A_f.indices()
    s = 1.0 / _nonzero(diagonal(A_f))
    DinvA = _coo(r, c, A_f.values() * s[r], A.shape)
    return (P_hat + (-OMEGA) * torch.sparse.mm(DinvA, P_hat)).coalesce()


def hierarchy(A: torch.Tensor, num_levels: int = 3, base_tol: float = 0.08,
              min_coarse: int = 8, agg=None) -> list:
    """[(A_k, 1/diag(A_k), P_k, R_k)], fine first; P_k and R_k move
    between level k and level k + 1 (None on the coarsest).  ``agg``: the
    first coarsening's aggregates, where a caller hands them over."""
    levels = []
    for k in range(1, num_levels):
        if A.shape[0] <= min_coarse:
            break
        strong = strength(A, base_tol * 0.5 ** (k - 1))
        a = agg if (k == 1 and agg is not None) else aggregates(A, strong)
        P = prolongator(A, a, strong)
        R = P.t().coalesce()
        A_c = torch.sparse.mm(R, torch.sparse.mm(A, P)).coalesce()
        if A_c.shape[0] >= A.shape[0]:
            break
        levels.append((A, 1.0 / _nonzero(diagonal(A)), P, R))
        A = A_c
    levels.append((A, 1.0 / _nonzero(diagonal(A)), None, None))
    return levels


def _mv(A, x):
    return torch.sparse.mm(A, x[:, None])[:, 0]


def v_cycle(levels, f, x, nu1=2, nu2=2, k=0):
    A, dinv, P, R = levels[k]
    if P is None:
        return torch.linalg.solve(A.to_dense(), f)
    for _ in range(nu1):
        x = x + OMEGA * dinv * (f - _mv(A, x))
    f_c = _mv(R, f - _mv(A, x))
    x_c = v_cycle(levels, f_c, torch.zeros_like(f_c), nu1, nu2, k + 1)
    x = x + _mv(P, x_c)
    for _ in range(nu2):
        x = x + OMEGA * dinv * (f - _mv(A, x))
    return x


def field_hierarchies(A: torch.Tensor, b: int, num_levels: int = 3) -> list:
    """One hierarchy per field, each from the field's own block."""
    return [hierarchy(field(A, p, b), num_levels) for p in range(b)]


def apply(hierarchies, r, num_iters=1, nu1=2, nu2=2):
    """M⁻¹ r: each field's unknowns r[p::b] through ``num_iters`` V-cycles
    of its own hierarchy from zero."""
    b = len(hierarchies)
    z = torch.empty_like(r)
    for p, levels in enumerate(hierarchies):
        x = torch.zeros_like(r[p::b])
        for _ in range(num_iters):
            x = v_cycle(levels, r[p::b], x, nu1, nu2)
        z[p::b] = x
    return z


def pcg(A, b, precond, tau=1e-10, maxiter=500):
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
