"""Classical Ruge-Stüben AMG coarsening (C/F splitting + direct
interpolation).

Copied verbatim from ``pysolvers_tpu/linear/amg_rs.py`` (numpy only;
importing that package imports jax).

Capability parity with the reference's stash (stash/AMGCoarsen.py:5-164
strength sets + priority C/F splitting, stash/AMGTransfer.py:22-137
classical interpolation) — which is dead code there; here it is a working
alternative coarsening for the same MLHierarchy/V-cycle machinery as SA
(amg.py).  Standard algorithm (Ruge & Stüben 1987), written fresh:

* strength: i strongly depends on j when  -a_ij >= theta * max_{k!=i}(-a_ik)
  (M-matrix convention); rows with NO negative off-diagonal couplings fall
  back to the magnitude test |a_ij| >= theta * max|a_ik| so sign-flipped /
  non-M input still coarsens
* C/F splitting: greedy max-measure (lambda = |S^T_i| influence count),
  standard first pass; isolated points (no strong connections) become
  F-points (smoothing alone handles them); F-points adjacent to no C-point
  promoted in a second pass
* interpolation: direct interpolation with row-sum preservation
  P_ij = -a_ij / (a_ii + sum_weak) * (sum of strong F contributions folded
  proportionally into C neighbors)  — the simple direct-interp variant.
"""
from __future__ import annotations

import numpy as np

from ..sparse.host import HostCSR


def rs_strength(A: HostCSR, theta: float = 0.25):
    """Boolean strong-dependence mask per nnz (off-diagonal)."""
    rows, cols, vals = A.to_coo()
    off = rows != cols
    n = A.shape[0]
    # strength of negative couplings (M-matrix style)
    neg = np.where(off, -vals, -np.inf)
    row_max = np.full(n, -np.inf)
    np.maximum.at(row_max, rows, neg)
    # magnitude fallback for rows with no negative off-diagonals
    # (sign-flipped assembly / non-M discretizations would otherwise get
    # zero strong connections and coarsening silently degenerates)
    mag = np.where(off, np.abs(vals), -np.inf)
    mag_max = np.full(n, -np.inf)
    np.maximum.at(mag_max, rows, mag)
    use_mag = ~(np.isfinite(row_max) & (row_max > 0))
    row_max = np.where(np.isfinite(row_max), row_max, 0.0)
    mag_max = np.where(np.isfinite(mag_max), mag_max, 0.0)
    strong_neg = (neg >= theta * row_max[rows]) & (neg > 0)
    strong_mag = (mag >= theta * mag_max[rows]) & (mag > 0)
    strong = off & np.where(use_mag[rows], strong_mag, strong_neg)
    return rows, cols, vals, strong


def rs_cf_split(A: HostCSR, theta: float = 0.25,
                strength=None) -> np.ndarray:
    """Return flags: 1 = C-point, 0 = F-point.  ``strength``: optional
    precomputed ``rs_strength`` result (shared with interpolation)."""
    n = A.shape[0]
    rows, cols, _, strong = strength or rs_strength(A, theta)
    srows, scols = rows[strong], cols[strong]
    # influence measure: lambda_j = |{i : j in S_i}| = count of j in scols
    lam = np.bincount(scols, minlength=n).astype(np.int64)

    # adjacency (dependence sets S_i and influence sets S^T_j)
    order = np.argsort(srows, kind="stable")
    dep_rows, dep_cols = srows[order], scols[order]
    dep_ptr = np.searchsorted(dep_rows, np.arange(n + 1))
    order_t = np.argsort(scols, kind="stable")
    inf_cols, inf_rows = scols[order_t], srows[order_t]
    inf_ptr = np.searchsorted(inf_cols, np.arange(n + 1))

    UNDECIDED, FPT, CPT = 0, 1, 2
    state = np.zeros(n, dtype=np.int8)
    lam = lam.astype(np.float64)
    # simple greedy loop with lazy priority updates
    import heapq
    heap = [(-lam[i], i) for i in range(n)]
    heapq.heapify(heap)
    while heap:
        negl, i = heapq.heappop(heap)
        if state[i] != UNDECIDED or -negl != lam[i]:
            continue
        deps = dep_cols[dep_ptr[i]: dep_ptr[i + 1]]
        if lam[i] == 0:
            # no remaining influence.  Isolated points (no strong
            # connections at all — Dirichlet/identity rows, weakly
            # coupled rows) become F: smoothing alone resolves them and
            # making them C would keep them on every coarse level.
            # Dependent-but-uninfluential points with a C neighbor can
            # interpolate — F; only those with no C dependency stay C.
            if len(deps) == 0 or (state[deps] == CPT).any():
                state[i] = FPT
                continue
        state[i] = CPT
        # points influenced by i become F
        for j in inf_rows[inf_ptr[i]: inf_ptr[i + 1]]:
            if state[j] == UNDECIDED:
                state[j] = FPT
                # their dependencies gain measure
                for k in dep_cols[dep_ptr[j]: dep_ptr[j + 1]]:
                    if state[k] == UNDECIDED:
                        lam[k] += 1
                        heapq.heappush(heap, (-lam[k], k))
    # second pass (safety net): F-points with strong dependencies but no
    # strong C neighbor become C so interpolation never hits a dead end
    for i in np.flatnonzero(state == FPT):
        deps = dep_cols[dep_ptr[i]: dep_ptr[i + 1]]
        if len(deps) and not (state[deps] == CPT).any():
            state[i] = CPT
    return (state == CPT).astype(np.int64)


def rs_interpolation(A: HostCSR, cpoint: np.ndarray, theta: float = 0.25,
                     strength=None) -> HostCSR:
    """Direct interpolation P: (n, n_c) — fully vectorized (the per-F-row
    Python loop cost seconds of host setup per level at DH scale)."""
    n = A.shape[0]
    cidx = np.cumsum(cpoint) - 1          # C-point -> coarse index
    n_c = int(cpoint.sum())
    rows, cols, vals, strong = strength or rs_strength(A, theta)
    diag = A.diagonal()

    f_row = cpoint[rows] == 0
    strong_c = strong & (cpoint[cols] == 1)
    # denom per F-row: a_ii plus every off-diagonal that is NOT a strong-C
    # coupling (weak + strong-F lumped onto the diagonal)
    others = f_row & (cols != rows) & ~strong_c
    wsum = np.zeros(n, dtype=np.float64)
    np.add.at(wsum, rows[others], vals[others])
    denom = diag + wsum
    denom = np.where(denom == 0, np.where(diag == 0, 1.0, diag), denom)

    sel = strong_c & f_row
    out_r = [np.flatnonzero(cpoint == 1)]      # C-points inject
    out_c = [cidx[out_r[0]]]
    out_v = [np.ones(len(out_r[0]))]
    out_r.append(rows[sel])
    out_c.append(cidx[cols[sel]])
    out_v.append(-vals[sel] / denom[rows[sel]])
    # F-rows with no strong-C coupling get a zero row (isolated F)

    return HostCSR.from_coo(np.concatenate(out_r), np.concatenate(out_c),
                            np.concatenate(out_v).astype(A.data.dtype),
                            (n, n_c))


def rs_coarsen(A: HostCSR, theta: float = 0.25):
    """One RS coarsening step: returns (P, R, A_coarse) — same contract as
    amg.sa_coarsen, so hierarchies mix and match coarsening strategies."""
    from .amg import make_restriction
    strength = rs_strength(A, theta)       # one O(nnz) pass, shared
    cpoint = rs_cf_split(A, theta, strength=strength)
    P = rs_interpolation(A, cpoint, theta, strength=strength)
    R = make_restriction(P, normalize=False)   # classical AMG: R = P^T
    A_c = R.matmat(A.matmat(P))
    return P, R, A_c
