"""Sparse triangular solves: the AMG "gs"/"sgs" smoothers and the ILU(t)/
IC(t) applies.

Port of ``pysolvers_tpu/ops/trisolve.py``.  The dependency DAG of a
triangular factor is levelized on the host; rows within a level are
independent and solved as one vectorized step (gather → multiply-reduce →
scatter).  The JAX ``lax.scan`` over the level chunks becomes a Python loop
(about ten device ops per chunk); the ``fori_loop`` of ``trisolve_jacobi``
one over the sweeps.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..sparse.device import resolve_device, torch_dtype
from ..sparse.host import HostCSR


@dataclasses.dataclass(frozen=True)
class TriSolvePlan:
    """Device-resident plan for one triangular factor.

    ell_data:   (n+1, k) off-diagonal values per row (dummy row n)
    ell_cols:   (n+1, k) column ids (padding → n, reads dummy x slot)
    diag:       (n+1,)   diagonal values (1.0 for unit-diagonal factors)
    levels:     (n_chunks, width) row ids per level chunk (padding → n)
    """

    ell_data: torch.Tensor
    ell_cols: torch.Tensor
    diag: torch.Tensor
    levels: torch.Tensor
    lower: bool

    @property
    def n(self):
        return self.diag.shape[0] - 1

    @staticmethod
    def from_numpy(ell_data, ell_cols, diag, levels, lower: bool,
                   dtype=None, device=None) -> "TriSolvePlan":
        device = resolve_device(device)
        dtype = torch_dtype(dtype)
        return TriSolvePlan(
            torch.as_tensor(ell_data, dtype=dtype, device=device),
            torch.as_tensor(ell_cols, dtype=torch.int64, device=device),
            torch.as_tensor(diag, dtype=dtype, device=device),
            torch.as_tensor(levels, dtype=torch.int64, device=device),
            bool(lower))


def _levelize(indptr, indices, n, lower: bool) -> np.ndarray:
    """Topological levels of the triangular dependency DAG (host).
    Fast path: native C++; fallback below."""
    from ..utils import native
    res = native.levelize(indptr, indices, n, lower)
    if res is not None:
        return res
    level = np.zeros(n, dtype=np.int64)
    if lower:
        order = range(n)
    else:
        order = range(n - 1, -1, -1)
    for i in order:
        deps = indices[indptr[i]: indptr[i + 1]]
        deps = deps[deps < i] if lower else deps[deps > i]
        if len(deps):
            level[i] = level[deps].max() + 1
    return level


def build_trisolve_plan(T: HostCSR, lower: bool, unit_diag: bool = False,
                        dtype=None, device=None) -> TriSolvePlan:
    """Levelize a triangular HostCSR and pack its rows for ``device``."""
    n = T.shape[0]
    dtype = dtype or T.data.dtype
    rows, cols, vals = T.to_coo()
    on_diag = rows == cols
    diag = np.ones(n + 1, dtype=T.data.dtype)
    if not unit_diag:
        dv = np.zeros(n, dtype=T.data.dtype)
        dv[rows[on_diag]] = vals[on_diag]
        if (dv == 0).any():
            raise ZeroDivisionError("triangular factor has zero diagonal")
        diag[:n] = dv
    off = ~on_diag
    orows, ocols, ovals = rows[off], cols[off], vals[off]

    counts = np.zeros(n + 1, dtype=np.int64)
    np.add.at(counts, orows, 1)
    k = max(int(counts.max()), 1)
    ell_data = np.zeros((n + 1, k), dtype=T.data.dtype)
    ell_cols = np.full((n + 1, k), n, dtype=np.int32)
    order = np.argsort(orows, kind="stable")
    orows, ocols, ovals = orows[order], ocols[order], ovals[order]
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:][: n])
    slot = np.arange(len(orows)) - starts[orows]
    ell_data[orows, slot] = ovals
    ell_cols[orows, slot] = ocols

    level = _levelize(T.indptr, T.indices, n, lower)
    n_levels = int(level.max()) + 1 if n else 1
    sizes = np.bincount(level, minlength=n_levels)
    # chunked schedule: levels are cut into fixed-width chunks so one huge
    # level doesn't pad every step to its width
    mean_w = max(int(n / max(n_levels, 1)), 1)
    width = int(min(max(2 * mean_w, 64), 4096))
    chunks_per_level = np.maximum((sizes + width - 1) // width, 1)
    n_chunks = int(chunks_per_level.sum())
    levels = np.full((n_chunks, width), n, dtype=np.int32)
    order = np.argsort(level, kind="stable")
    lv_sorted = level[order]
    pos_in_level = np.arange(n) - np.searchsorted(lv_sorted, lv_sorted)
    chunk_base = np.concatenate([[0], np.cumsum(chunks_per_level)[:-1]])
    chunk_idx = chunk_base[lv_sorted] + pos_in_level // width
    levels[chunk_idx, pos_in_level % width] = order

    return TriSolvePlan.from_numpy(ell_data, ell_cols, diag, levels, lower,
                                   dtype=dtype, device=device)


def trisolve(plan: TriSolvePlan, b: torch.Tensor) -> torch.Tensor:
    """Solve T x = b with the level schedule, one step per level chunk."""
    n = plan.n
    dt = torch.promote_types(b.dtype, plan.ell_data.dtype)
    bp = torch.cat([b.to(dt), b.new_zeros(1, dtype=dt)])
    x = torch.zeros(n + 1, dtype=dt, device=b.device)
    for rows in plan.levels:
        d = plan.ell_data[rows]                        # (width, k)
        c = plan.ell_cols[rows]
        acc = torch.sum(d * x[c], dim=1)
        x[rows] = (bp[rows] - acc) / plan.diag[rows]
    return x[:n].to(b.dtype)


def trisolve_jacobi(plan: TriSolvePlan, b: torch.Tensor, sweeps: int = 10
                    ) -> torch.Tensor:
    """Approximate triangular solve by fixed-point (Jacobi) sweeps:
    x_{k+1} = D^{-1}(b - N x_k) with T = D + N, from x_0 = 0.  Converges in
    <= n_levels sweeps (N is nilpotent); ``sweeps`` trades accuracy for
    time.  Promotes like ``trisolve``."""
    n = plan.n
    dt = torch.promote_types(b.dtype, plan.ell_data.dtype)
    bp = torch.cat([b.to(dt), b.new_zeros(1, dtype=dt)])
    x = torch.zeros(n + 1, dtype=dt, device=b.device)
    for _ in range(sweeps):
        acc = torch.sum(plan.ell_data * x[plan.ell_cols], dim=1)
        x = ((bp - acc) / plan.diag).to(dt)
        x[n] = 0.0
    return x[:n].to(b.dtype)
