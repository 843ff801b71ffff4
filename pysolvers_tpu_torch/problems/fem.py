"""Unstructured FEM / graph-Laplacian test problems (host assembly, numpy).

The reference's graded problem family is the Debye-Hückel FEM suite
(the reference's examples/DHTestProblem.py:6-36) — real unstructured FEM
matrices, but capped at n=16,641 (lev 15).  These generators extend that
capability to arbitrary n so the SA-AMG path (the reference's production
multigrid, SmoothedAggregation.py:185-205) can be exercised at the scales
the TPU build targets (n >= 1e6).

``fem_poisson_2d_unstructured`` assembles a genuine P1 finite-element
stiffness matrix on a perturbed triangulation: grid points are jittered,
every quad cell is split along a randomly chosen diagonal (so node degrees
vary 4..8 and the sparsity graph is NOT a tensor stencil), the diffusion
coefficient varies smoothly per element, and node numbering is randomly
shuffled.  The result is SPD with Dirichlet conditions eliminated — the
same matrix class as the DH suite, at any size.

Copied from ``pysolvers_tpu/problems/fem.py``, code unchanged (importing
that package imports jax).
"""
from __future__ import annotations

import numpy as np

from ..sparse.host import HostCSR


def fem_poisson_2d_unstructured(m: int, seed: int = 0, jitter: float = 0.22,
                                dtype=np.float64, shuffle: bool = True,
                                coeff: bool = True):
    """P1 FEM stiffness matrix for -div(a grad u) on a jittered
    triangulation of the unit square.

    ``m``: cells per side; nodes form an (m+1)x(m+1) cloud, boundary
    nodes are eliminated (homogeneous Dirichlet), so the returned system
    has n = (m-1)^2 unknowns (m=1025 -> n=1,048,576).

    ``jitter``: interior node perturbation as a fraction of h (kept small
    enough that all triangles stay positively oriented — asserted).

    ``shuffle``: randomly permute the unknown numbering, so the returned
    matrix carries no grid ordering at all (callers that want bandwidth
    back run RCM, e.g. HostCSR.permute_symmetric with a
    BwsMatrix._rcm_perm ordering — the realistic unstructured pipeline).

    Returns ``HostCSR`` (SPD).
    """
    rng = np.random.default_rng(seed)
    h = 1.0 / m
    # node cloud: structured positions + jitter on interior nodes
    xi = np.linspace(0.0, 1.0, m + 1)
    X, Y = np.meshgrid(xi, xi, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)
    n_nodes = (m + 1) * (m + 1)
    interior_mask = ((X > 0) & (X < 1) & (Y > 0) & (Y < 1)).ravel()
    pert = rng.uniform(-jitter * h, jitter * h, size=(n_nodes, 2))
    pts = pts + np.where(interior_mask[:, None], pert, 0.0)

    # triangulation: split each cell along a random diagonal
    ii, jj = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
    ii, jj = ii.ravel(), jj.ravel()
    v00 = ii * (m + 1) + jj
    v10 = (ii + 1) * (m + 1) + jj
    v01 = ii * (m + 1) + (jj + 1)
    v11 = (ii + 1) * (m + 1) + (jj + 1)
    diag = rng.integers(0, 2, size=m * m).astype(bool)
    # diag=0: split 00-11 -> (00,10,11), (00,11,01)
    # diag=1: split 10-01 -> (00,10,01), (10,11,01)
    tris = np.where(
        diag[:, None, None],
        np.stack([np.stack([v00, v10, v01], 1),
                  np.stack([v10, v11, v01], 1)], 1),
        np.stack([np.stack([v00, v10, v11], 1),
                  np.stack([v00, v11, v01], 1)], 1),
    ).reshape(-1, 3)                               # (2 m^2, 3)

    p0, p1, p2 = pts[tris[:, 0]], pts[tris[:, 1]], pts[tris[:, 2]]
    # signed doubled area; jitter bound keeps orientation positive
    det = ((p1[:, 0] - p0[:, 0]) * (p2[:, 1] - p0[:, 1])
           - (p2[:, 0] - p0[:, 0]) * (p1[:, 1] - p0[:, 1]))
    if not (det > 0).all():
        raise AssertionError("degenerate triangle — lower `jitter`")
    area = 0.5 * det

    # P1 gradients: grad(lambda_k) from edge rotations
    e0 = p2 - p1
    e1 = p0 - p2
    e2 = p1 - p0
    grads = np.stack([e0, e1, e2], axis=1)         # (nt, 3, 2)
    grads = grads[:, :, ::-1] * np.array([1.0, -1.0])   # rotate 90°
    grads = grads / det[:, None, None]

    if coeff:
        c = (p0 + p1 + p2) / 3.0
        a_e = np.exp(0.8 * np.sin(3 * np.pi * c[:, 0])
                     * np.sin(2 * np.pi * c[:, 1]))
    else:
        a_e = np.ones(len(tris))

    # element stiffness K_kl = a_e * area * grad_k . grad_l
    K = np.einsum("tkd,tld->tkl", grads, grads) * (a_e * area)[:, None, None]

    rows = np.repeat(tris, 3, axis=1).ravel()      # (nt*9,)
    cols = np.tile(tris, (1, 3)).ravel()
    vals = K.transpose(0, 2, 1).ravel()

    # eliminate Dirichlet boundary nodes
    keep = interior_mask[rows] & interior_mask[cols]
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    new_id = np.full(n_nodes, -1, dtype=np.int64)
    ids = np.flatnonzero(interior_mask)
    n = len(ids)
    if shuffle:
        new_id[ids] = rng.permutation(n)
    else:
        new_id[ids] = np.arange(n)
    return HostCSR.from_coo(new_id[rows], new_id[cols],
                            vals.astype(dtype), (n, n))


def graph_laplacian_rgg(n: int, k: int = 6, seed: int = 0,
                        dtype=np.float64, shift: float = 1e-3) -> HostCSR:
    """SPD graph Laplacian of a random geometric graph: n points in the
    unit square, each connected to its ~k nearest neighbors found through
    a cell-bucket sweep (vectorized numpy, no scipy), weights 1/dist,
    symmetrized, plus ``shift``·I to pin the nullspace.  A second
    unstructured family (pure graph, no mesh) for calibration sweeps."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.0, 1.0, size=(n, 2))
    # bucket side ~ sqrt(k / n): expected k points per 3x3 neighborhood/9
    g = max(int(np.sqrt(n / max(k, 1)) * 1.5), 1)
    cell = np.minimum((pts * g).astype(np.int64), g - 1)
    cid = cell[:, 0] * g + cell[:, 1]
    order = np.argsort(cid, kind="stable")
    cid_s = cid[order]
    starts = np.searchsorted(cid_s, np.arange(g * g + 1))
    rows_l, cols_l, w_l = [], [], []
    r = 1.2 * np.sqrt(k / (np.pi * n))             # target radius
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            # pair each point with all points in the offset cell
            nb = (cell[:, 0] + dx) * g + (cell[:, 1] + dy)
            ok = ((cell[:, 0] + dx >= 0) & (cell[:, 0] + dx < g)
                  & (cell[:, 1] + dy >= 0) & (cell[:, 1] + dy < g))
            src = np.flatnonzero(ok)
            lo, hi = starts[nb[ok]], starts[nb[ok] + 1]
            cnt = hi - lo
            src = np.repeat(src, cnt)
            tgt = order[np.repeat(lo - np.cumsum(cnt) + cnt, cnt)
                        + np.arange(cnt.sum())]
            d = np.sqrt(((pts[src] - pts[tgt]) ** 2).sum(1))
            sel = (d < r) & (src != tgt)
            rows_l.append(src[sel])
            cols_l.append(tgt[sel])
            w_l.append(1.0 / np.maximum(d[sel], 1e-12))
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    w = np.concatenate(w_l)
    # graph Laplacian: L = D - W (+ shift I); W already symmetric by sweep
    deg = np.zeros(n)
    np.add.at(deg, rows, w)
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    vals = np.concatenate([-w, deg + shift])
    return HostCSR.from_coo(rows, cols, vals.astype(dtype), (n, n))
