"""Structured-grid geometric multigrid: gather-free V-cycles.

Port of ``pysolvers_tpu/linear/gmg_grid.py``.  On a uniform 1-D/2-D
Dirichlet grid the transfers are structured: prolongation is interleave +
neighbour averaging, restriction is full weighting — strided slicing and
adds, no sparse transfer operators.  Level operators are stencils, stored
as ``DiaMatrix`` (kernel K1 on CUDA) or, on 2-D grids of m >=
``GRID_KERNEL_MIN_M``, as ``GridDiaMatrix`` (kernel K6).

Exactness contract: ``grid_prolong`` / ``grid_restrict`` compute exactly
the same linear maps as ``gmg.interp_1d/interp_2d`` and the row-normalized
transpose (``amg.make_restriction``), so the Galerkin hierarchy from
``gmg.build_gmg_hierarchy`` applies unchanged (the tests pin this).  The
2-D transfers slice along dim -2 directly instead of transposing, so a
fine vector of 1e8 entries is not copied by the layout changes.

* ``build_grid_hierarchy`` — the host-Galerkin hierarchy: levels from
  ``gmg.build_gmg_hierarchy`` uploaded as DIA stencils, Chebyshev bounds
  from the host power iteration ``estimate_lmax``, the coarsest inverse by
  host ``np.linalg.inv``.
* ``build_grid_hierarchy_device`` — every coarse level probed on the
  device from the resident fine DIA operator (``_probe_coarse_dia``: comb
  vectors through the structured transfers and ``dia_spmm``), per-level
  1/diag, Chebyshev bounds by a Gershgorin upper bound off the DIA table
  (power iteration under-estimates lambda_max on clustered-top spectra —
  measured 1.94 against 1.98 — enough to make Chebyshev diverge on the top
  modes), and the coarsest dense inverse by ``torch.linalg.inv`` on the
  device.  ``checkpoint=`` persists the probed products in the JAX
  package's ``.npz`` layout, at any size.

The JAX package's comb read-out uses one-hot einsums (the TPU's way around
gathers); the port indexes the comb responses instead — each extracted
entry is one nonzero term, so the values agree.  Its ``lax.map`` over comb
chunks on huge grids is a Python loop here: eager torch runs the chunks in
order, so the peak stays bounded.

Not ported (TPU compile and tunnel workarounds, Pallas and Mosaic
plumbing): ``_build_device_levels`` (the fused whole-hierarchy jit),
``_SPLIT_BUILD_N`` (the port has the per-level path only), the ``_retry``
on ``remote_compile``, the ``_DEVICE_BUILD_CACHE`` jits, the ``ops/fuse.py``
``SetupItem``/``fused_build`` blob and ``inv_from_coo_build``,
``prep_operator``/``DiaTiled`` (the port's levels are ``DiaMatrix``),
``ops/dense_inverse.py``, and ``grid_vc_apply``'s module-level identity
cache (it keyed JAX's compile caches).
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops import matvec
from ..ops.grid_spmv import GridDiaMatrix
from ..ops.spmv import dia_spmm_rows
from ..sparse.device import DiaMatrix, numpy_dtype, resolve_device
from ..sparse.host import HostCSR
from ..utils.timing import Timer
from .amg import MLHierarchy, _smooth
from .gmg import build_gmg_hierarchy, refinement_ms

# a 2-D level of at least this width runs its stencil as a GridDiaMatrix
# (kernel K6); narrower levels stay flat DIA (kernel K1).  The JAX
# package's rule, kept for parity; not a user option.
GRID_KERNEL_MIN_M = 4096

# above this many fine points the probe runs its comb batch in s chunks
# of s combs, so that the (batch, n_f) temporaries stay bounded
_PROBE_CHUNK_N = 1 << 23


# ---------------------------------------------------------------------------
# Grid transfers (strided slicing — no gathers, no scatters)
# ---------------------------------------------------------------------------

def _at(dim: int, ndim: int, sl) -> tuple:
    """Index tuple applying ``sl`` along ``dim`` of an ``ndim``-D tensor."""
    idx = [slice(None)] * ndim
    idx[dim] = sl
    return tuple(idx)


def _prolong_dim(X: torch.Tensor, m_f: int, dim: int) -> torch.Tensor:
    """Linear interpolation along ``dim``: m_c → m_f = 2·m_c + 1 points
    (gmg.interp_1d's map).

    fine[2c+1] = coarse[c]; fine[2k] = (coarse[k−1] + coarse[k])/2 with
    Dirichlet zeros outside (0.5·(0 + v) at the two ends)."""
    nd = X.ndim
    shape = list(X.shape)
    shape[dim] = m_f
    out = X.new_empty(shape)
    out[_at(dim, nd, slice(1, None, 2))] = X
    out[_at(dim, nd, slice(2, -1, 2))] = 0.5 * (
        X[_at(dim, nd, slice(None, -1))] + X[_at(dim, nd, slice(1, None))])
    out[_at(dim, nd, slice(0, 1))] = 0.5 * X[_at(dim, nd, slice(0, 1))]
    out[_at(dim, nd, slice(-1, None))] = 0.5 * X[_at(dim, nd, slice(-1, None))]
    return out


def _restrict_dim(X: torch.Tensor, dim: int) -> torch.Tensor:
    """Full weighting along ``dim``: m_f → m_c points.

    coarse[c] = fine[2c]/4 + fine[2c+1]/2 + fine[2c+2]/4 — exactly the
    row-normalized transpose of ``_prolong_dim`` (make_restriction)."""
    nd = X.ndim
    e = X[_at(dim, nd, slice(0, None, 2))]                 # m_c + 1
    o = X[_at(dim, nd, slice(1, None, 2))]                 # m_c
    return 0.5 * o + 0.25 * (e[_at(dim, nd, slice(None, -1))]
                             + e[_at(dim, nd, slice(1, None))])


def grid_prolong(x: torch.Tensor, ndim: int, m_c: int,
                 m_f: int) -> torch.Tensor:
    """Interpolate a flat interior-grid vector coarse → fine."""
    if ndim == 1:
        return _prolong_dim(x, m_f, -1)
    X = _prolong_dim(x.reshape(m_c, m_c), m_f, -1)
    return _prolong_dim(X, m_f, -2).reshape(m_f * m_f)


def grid_restrict(x: torch.Tensor, ndim: int, m_f: int,
                  m_c: int) -> torch.Tensor:
    """Full-weighting restriction of a flat interior-grid vector."""
    if ndim == 1:
        return _restrict_dim(x, -1)
    X = _restrict_dim(x.reshape(m_f, m_f), -1)
    return _restrict_dim(X, -2).reshape(m_c * m_c)


# ---------------------------------------------------------------------------
# Hierarchy
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GridLevel:
    A_dev: object                    # DIA or grid-DIA stencil operator
    dinv: Optional[torch.Tensor]     # 1/diag for Jacobi/Chebyshev
    cheb: Optional[tuple]            # (theta, delta) for Chebyshev


@dataclasses.dataclass
class GridHierarchy:
    levels: List[GridLevel]          # coarsest-first; levels[0] unused
    A0_inv: torch.Tensor             # coarsest dense inverse
    ms: tuple                        # interior points per dimension
    ndim: int
    smoother: str
    nu_pre: int
    nu_post: int

    @property
    def n_levels(self):
        return len(self.levels)

    @property
    def device(self) -> torch.device:
        return self.A0_inv.device


def _check_smoother(smoother: str) -> str:
    if smoother == "auto":
        smoother = "jacobi"      # the grid executor's native choice
    if smoother not in ("jacobi", "chebyshev"):
        raise ValueError("grid executor supports smoother='jacobi' or "
                         "'chebyshev' (got %r)" % (smoother,))
    return smoother


def build_grid_hierarchy(A: Optional[HostCSR], num_levels: int,
                         dims: Tuple[int, ...], smoother: str = "jacobi",
                         nu_pre: int = 2, nu_post: int = 2,
                         dtype=np.float32,
                         mlh: Optional[MLHierarchy] = None,
                         galerkin: str = "host",
                         device=None) -> GridHierarchy:
    """Galerkin hierarchy (gmg.build_gmg_hierarchy) lowered as DIA
    stencils on ``device`` (None: the current CUDA device).  Smoothers:
    "jacobi" (ω=2/3) or "chebyshev" (GS needs triangular solves — use the
    sparse executor for that).

    Pass ``mlh`` to lower an already-built Galerkin sequence (the OO
    shell's hierarchy hook); otherwise it is built from ``A``.

    ``galerkin``: "host" computes coarse operators by host SpGEMM and
    uploads every level; "device" probes them on the device from the fine
    DIA operator (``build_grid_hierarchy_device`` — no host SpGEMM, no
    coarse uploads); "auto" picks "device" on CUDA when building from
    ``A``, else "host"."""
    device = resolve_device(device)
    if galerkin == "auto":
        galerkin = ("device" if mlh is None and A is not None
                    and device.type == "cuda" else "host")
    if galerkin == "device":
        if mlh is not None:
            raise ValueError("galerkin='device' builds from the fine "
                             "operator; it cannot lower a pre-built mlh")
        if A is None:
            raise ValueError("galerkin='device' requires the fine "
                             "operator A")
        A_dev = DiaMatrix.from_host_csr(A, dtype=dtype, device=device)
        return build_grid_hierarchy_device(A_dev, num_levels, dims,
                                           smoother, nu_pre, nu_post)
    if galerkin != "host":
        raise ValueError("galerkin must be 'host', 'device' or 'auto' "
                         "(got %r)" % (galerkin,))
    smoother = _check_smoother(smoother)
    dtype = numpy_dtype(dtype)
    if mlh is None:
        mlh = build_gmg_hierarchy(A, num_levels, dims)
    # interior-point counts per level, coarsest-first (mlh order)
    ndim = len(dims)
    n_of = (lambda m: m) if ndim == 1 else (lambda m: m * m)
    ms = []
    for M in mlh.matrices:
        m_here = M.shape[0] if ndim == 1 else int(round(M.shape[0] ** 0.5))
        if n_of(m_here) != M.shape[0]:
            raise ValueError("level size %d is not a %d-D interior grid"
                             % (M.shape[0], ndim))
        ms.append(m_here)

    from .preconditioner import ChebyshevPreconditionerType
    levels: List[GridLevel] = []
    for k, M in enumerate(mlh.matrices):
        if k == 0:
            # coarsest: dense inverse only — also when it is the ONLY
            # level (v_cycle_grid then just applies A0_inv)
            levels.append(GridLevel(None, None, None))
            continue
        d = M.diagonal()
        d = np.where(d == 0, 1.0, d)
        Ad = DiaMatrix.from_host_csr(
            HostCSR(M.indptr, M.indices, M.data.astype(dtype), M.shape),
            dtype=dtype, device=device)
        cheb = None
        if smoother == "chebyshev":
            lmax = ChebyshevPreconditionerType().estimate_lmax(M)
            lmin = lmax / 30.0
            cheb = (0.5 * (lmax + lmin), 0.5 * (lmax - lmin))
        dinv = torch.as_tensor((1.0 / d).astype(dtype), device=device)
        levels.append(GridLevel(Ad, dinv, cheb))
    A0 = mlh.matrices[0].to_dense().astype(np.float64)
    with Timer("gmg.coarse_inverse"):
        A0_inv = np.linalg.inv(A0)
    return GridHierarchy(levels, torch.as_tensor(A0_inv.astype(dtype),
                                                 device=device),
                         tuple(ms), ndim, smoother, nu_pre, nu_post)


# ---------------------------------------------------------------------------
# Device-probed Galerkin: coarse stencils built ON THE DEVICE
# ---------------------------------------------------------------------------

def _stencil_reach(offsets, m: int, ndim: int) -> int:
    """Per-dimension reach of a DIA stencil on an m-wide interior grid.

    2-D flat offsets decode as off = da·m + db with |db| ≪ m (stencil
    widths are tiny against the grid)."""
    r = 0
    for off in offsets:
        if ndim == 1:
            da, db = 0, off
        else:
            db = ((off + m // 2) % m) - m // 2
            da = (off - db) // m
        r = max(r, abs(da), abs(db))
    if r > m // 2:
        # the modular decode above is only unambiguous for reach <= m/2;
        # a wider stencil probed onto this grid would alias comb teeth
        # and silently corrupt the probed coarse operator
        raise ValueError("stencil reach %d exceeds m//2 = %d on an "
                         "m=%d grid — too wide to probe" % (r, m // 2, m))
    return r


def _probe_coarse_dia(A_f: DiaMatrix, ndim: int, m_f: int,
                      m_c: int) -> DiaMatrix:
    """Coarse Galerkin operator A_c = R·A_f·P extracted by comb probing,
    all on A_f's device — no host SpGEMM, no coarse-level upload.

    P/R are the structured transfers (grid_prolong/grid_restrict), so
    columns of A_c are exactly (R A_f P)·e_c.  Probe with comb vectors
    (one 1 every ``s`` points per dimension, s = 2·reach+1): combs are far
    enough apart that responses of distinct columns never overlap, so
    s^ndim applications of the pipeline recover EVERY column.  Diagonal
    offset (da, db) of coarse row (a, b) is read from the response of the
    comb whose phase holds column (a-da, b-db).
    """
    r_f = _stencil_reach(A_f.offsets, m_f, ndim)
    rc = (r_f + 2) // 2                    # |k-c| <= (r_f+2)/2 coarse pts
    s = 2 * rc + 1
    dtype, device = A_f.dtype, A_f.device
    n_c = m_c ** ndim
    ar = torch.arange(m_c, device=device)

    def pipeline_batch(V):
        """(K, n_c) comb batch → (K, n_c) responses: batch-aware strided
        transfers and one dia_spmm pass for all combs."""
        K = V.shape[0]
        if ndim == 1:
            U = _prolong_dim(V, m_f, -1)                   # (K, m_f)
        else:
            X = _prolong_dim(V.reshape(K, m_c, m_c), m_f, -1)
            U = _prolong_dim(X, m_f, -2).reshape(K, m_f ** ndim)
            del X
        W = dia_spmm_rows(A_f, U)                          # (K, n_f)
        del U
        if ndim == 1:
            return _restrict_dim(W, -1)
        X = _restrict_dim(W.reshape(K, m_f, m_f), -1)
        del W
        return _restrict_dim(X, -2).reshape(K, n_c)

    deltas = range(-rc, rc + 1)
    if ndim == 1:
        combs = torch.stack([(ar % s == p).to(dtype) for p in range(s)])
        Y = pipeline_batch(combs)                          # (s, m_c)
        entries = {}
        for da in deltas:
            # row a holds A_c[a, a-da]; its column's comb phase is (a-da)%s
            D = Y[(ar - da) % s, ar]
            entries[-da] = D * ((ar - da >= 0) & (ar - da < m_c)).to(dtype)
    else:
        def comb(px, py):
            return ((ar % s == px)[:, None] & (ar % s == py)[None, :]
                    ).to(dtype).reshape(-1)

        phases = [(px, py) for px in range(s) for py in range(s)]
        Y = torch.empty((s * s, n_c), dtype=dtype, device=device)
        # huge grids: one batch of all s^2 combs materializes (s^2, n_f)
        # temporaries (~2.5 GB each per 3 combs at n = 1e8, f64); s chunks
        # of s combs, run in order, bound the peak
        step = s if m_f ** ndim > _PROBE_CHUNK_N else s * s
        for i in range(0, s * s, step):
            Y[i: i + step] = pipeline_batch(torch.stack(
                [comb(px, py) for px, py in phases[i: i + step]]))
        entries = {}
        for da in deltas:
            pa = (ar - da) % s
            va = ((ar - da >= 0) & (ar - da < m_c)).to(dtype)
            for db in deltas:
                pb = (ar - db) % s
                vb = ((ar - db >= 0) & (ar - db < m_c)).to(dtype)
                # row (a, b) reads the comb of phase (pa[a], pb[b])
                ph = (pa[:, None] * s + pb[None, :]).reshape(1, -1)
                D = torch.gather(Y, 0, ph).reshape(m_c, m_c)
                entries[-(da * m_c + db)] = (
                    D * va[:, None] * vb[None, :]).reshape(-1)
    offsets = sorted(entries)
    table = torch.zeros((len(offsets), -(-n_c // 32) * 32), dtype=dtype,
                        device=device)
    for i, off in enumerate(offsets):
        table[i, :n_c] = entries.pop(off)
    return DiaMatrix(table, tuple(int(o) for o in offsets),
                     torch.tensor(offsets, dtype=torch.int32, device=device),
                     (n_c, n_c))


def _level_stats(diags: torch.Tensor, offsets, n_k: int, need_cheb: bool):
    """A level's own 1/diag and, for Chebyshev, its (theta, delta) from
    the Gershgorin bound max_i dinv_i · sum_d |A[i, i+off_d]| — always an
    UPPER bound on lambda_max(D^{-1}A)."""
    d = diags[offsets.index(0), :n_k]
    d = torch.where(d == 0, torch.ones_like(d), d)
    cheb = None
    if need_cheb:
        rowsum = torch.sum(torch.abs(diags[:, :n_k]), dim=0)
        lmax = float(torch.max(rowsum / torch.abs(d)))
        lmin = lmax / 30.0
        cheb = (0.5 * (lmax + lmin), 0.5 * (lmax - lmin))
    return 1.0 / d, cheb


def _coarsest_inverse(diags: torch.Tensor, offsets, n0: int) -> torch.Tensor:
    """Dense inverse of the coarsest probed level, on its device."""
    A0 = DiaMatrix(diags, offsets,
                   torch.tensor(offsets, dtype=torch.int32,
                                device=diags.device), (n0, n0))
    eye = torch.eye(n0, dtype=diags.dtype, device=diags.device)
    return torch.linalg.inv(dia_spmm_rows(A0, eye).T)


def _sync(device: torch.device):
    """Wait for the device, so that a setup timer measures its work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _dia(tbl: torch.Tensor, offsets, n: int) -> DiaMatrix:
    return DiaMatrix(tbl, tuple(offsets),
                     torch.tensor(offsets, dtype=torch.int32,
                                  device=tbl.device), (n, n))


def build_grid_hierarchy_device(A_dev: DiaMatrix, num_levels: int,
                                dims: Tuple[int, ...],
                                smoother: str = "jacobi",
                                nu_pre: int = 2,
                                nu_post: int = 2,
                                checkpoint: str = None) -> GridHierarchy:
    """GridHierarchy built on A_dev's device from the resident fine DIA
    operator: coarse Galerkin levels by comb probing
    (``_probe_coarse_dia``, level by level), per-level 1/diag, Chebyshev
    bounds by the Gershgorin upper bound (NOT power iteration — unlike the
    host path's ``estimate_lmax``), and the coarsest dense inverse by
    ``torch.linalg.inv``.  Nothing but the fine operator crosses the
    host↔device link.  Timers (synchronized on CUDA): "gmg.probe m_f->m_c"
    per level, "gmg.grid_convert", "gmg.coarse_inverse".

    ``checkpoint``: .npz path for the probed products (coarse tables, 1/diag,
    Chebyshev bounds, coarsest inverse), in the JAX package's layout, so a
    file either package wrote loads in the other.  The file is validated
    against the fine operator's structure and a value digest computed on
    the device; a mismatch rebuilds and overwrites.
    """
    smoother = _check_smoother(smoother)
    ndim = len(dims)
    if ndim == 2 and dims[0] != dims[1]:
        raise ValueError("2-D GMG needs a square m×m grid (got %r)"
                         % (dims,))
    if A_dev.shape[0] != dims[0] ** ndim:
        raise ValueError("operator size %d does not match a %d-D grid of "
                         "width %d (expected %d)"
                         % (A_dev.shape[0], ndim, dims[0],
                            dims[0] ** ndim))
    ms = tuple(refinement_ms(dims[0], num_levels))[::-1]   # coarsest-first
    need_cheb = smoother == "chebyshev"

    loaded = None
    if checkpoint is not None:
        loaded = _try_load_hier_ckpt(checkpoint, A_dev, ms, ndim, need_cheb)
    if loaded is not None:
        out_levels, A0_inv = loaded
    else:
        out_levels = []
        tbl = A_dev.diags
        offs = A_dev.offsets
        for k in range(len(ms) - 1, 0, -1):    # fine -> coarse
            dinv, cheb = _level_stats(tbl, offs, ms[k] ** ndim, need_cheb)
            out_levels.append((tbl, dinv, cheb))
            with Timer(f"gmg.probe {ms[k]}->{ms[k - 1]}"):
                tbl = _probe_coarse_dia(_dia(tbl, offs, ms[k] ** ndim), ndim,
                                        ms[k], ms[k - 1]).diags
                _sync(tbl.device)
            offs = _probed_offsets(A_dev.offsets, ms, ndim, k - 1)
        with Timer("gmg.coarse_inverse"):
            A0_inv = _coarsest_inverse(tbl, offs, ms[0] ** ndim)
            _sync(A0_inv.device)
        out_levels.reverse()                   # coarsest-first
        if checkpoint is not None:
            _save_hier_ckpt(checkpoint, out_levels, A0_inv, A_dev, ms,
                            ndim, need_cheb)

    levels: List[GridLevel] = [GridLevel(None, None, None)]
    for k in range(1, len(ms)):
        tbl, dinv, cheb = out_levels[k - 1]
        Ak = _dia(tbl, _probed_offsets(A_dev.offsets, ms, ndim, k),
                  ms[k] ** ndim)
        if ndim == 2 and ms[k] >= GRID_KERNEL_MIN_M:
            # huge grids: the grid kernel reads each stencil row pair
            # directly (the TPU's 1-D windowed kernel expanded x by
            # 1 + m/tile here; JAX's rule kept)
            try:
                with Timer("gmg.grid_convert"):
                    Ak = GridDiaMatrix.from_dia_device(Ak, (ms[k], ms[k]))
                    _sync(Ak.device)
            except ValueError:
                pass
        levels.append(GridLevel(Ak, dinv, cheb))
    return GridHierarchy(levels, A0_inv, ms, ndim, smoother, nu_pre,
                         nu_post)


def _hier_fingerprint(diags: torch.Tensor) -> np.ndarray:
    """Two-f64-reduction value digest of the fine DIA table, computed on
    its device."""
    return np.array([
        float(torch.sum(diags, dtype=torch.float64)),
        float(torch.linalg.vector_norm(diags, ord=1, dtype=torch.float64))])


def _save_hier_ckpt(path, out_levels, A0_inv, A_dev, ms, ndim, need_cheb):
    """Persist the probed products: every COARSE level's (table, dinv,
    cheb) plus the coarsest inverse.  The fine table itself (out_levels'
    last entry — multi-GB, re-assemblable by the caller) is not stored;
    its stats are recomputed on load.  Atomic write (tmp + rename)."""
    arrays = dict(
        meta_ms=np.asarray(ms, dtype=np.int64),
        meta_ndim=np.asarray([ndim], dtype=np.int64),
        meta_cheb=np.asarray([int(need_cheb)], dtype=np.int64),
        meta_offsets=np.asarray(A_dev.offsets, dtype=np.int64),
        meta_dtype=np.frombuffer(
            numpy_dtype(A_dev.dtype).name.encode(), dtype=np.uint8),
        meta_fp=_hier_fingerprint(A_dev.diags),
        A0_inv=A0_inv.cpu().numpy(),
    )
    for k, (tbl, dinv, cheb) in enumerate(out_levels[:-1]):
        arrays[f"tbl_{k}"] = tbl.cpu().numpy()
        arrays[f"dinv_{k}"] = dinv.cpu().numpy()
        if cheb is not None:
            arrays[f"cheb_{k}"] = np.asarray(cheb)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _try_load_hier_ckpt(path, A_dev, ms, ndim, need_cheb):
    """Reload probed products if ``path`` matches this fine operator
    (structure + device value digest, rtol 1e-9 — distinct matrices
    differ at O(1), reductions in another order at O(eps)); else None and
    the caller re-probes and overwrites."""
    if not os.path.exists(path):
        return None
    dev = A_dev.device
    dtype = A_dev.dtype
    try:
        with np.load(path) as d:
            if (tuple(d["meta_ms"]) != tuple(ms)
                    or int(d["meta_ndim"][0]) != ndim
                    or bool(d["meta_cheb"][0]) != bool(need_cheb)
                    or tuple(d["meta_offsets"]) != tuple(A_dev.offsets)
                    or bytes(d["meta_dtype"]).decode()
                    != numpy_dtype(dtype).name):
                return None
            if not np.allclose(_hier_fingerprint(A_dev.diags), d["meta_fp"],
                               rtol=1e-9, atol=0):
                return None
            # out_levels carries len(ms)-1 entries (levels 1..L-1, coarsest
            # first); the LAST one is the fine level, recomputed below, so
            # the file stores len(ms)-2 coarse entries
            out_levels = []
            for k in range(len(ms) - 2):
                cheb = (tuple(float(v) for v in d[f"cheb_{k}"])
                        if f"cheb_{k}" in d.files else None)
                out_levels.append((
                    torch.as_tensor(d[f"tbl_{k}"], dtype=dtype, device=dev),
                    torch.as_tensor(d[f"dinv_{k}"], dtype=dtype, device=dev),
                    cheb))
            A0_inv = torch.as_tensor(d["A0_inv"], dtype=dtype, device=dev)
    except (KeyError, ValueError, OSError):
        return None
    # fine-level stats: one elementwise pass, no probing
    dinv_f, cheb_f = _level_stats(A_dev.diags, A_dev.offsets,
                                  ms[-1] ** ndim, need_cheb)
    out_levels.append((A_dev.diags, dinv_f, cheb_f))
    return out_levels, A0_inv


def _probed_offsets(fine_offsets, ms, ndim: int, k: int):
    """Static offset tuple of level k (coarsest-first) as produced by the
    probing chain: the finest level keeps ``fine_offsets``; every probed
    level has the full reach-rc box pattern, sorted ascending."""
    if k == len(ms) - 1:
        return fine_offsets
    # reach chain: r_{next} = (r + 2) // 2, starting from the fine reach
    r = _stencil_reach(fine_offsets, ms[-1], ndim)
    for lev in range(len(ms) - 2, k - 1, -1):
        r = (r + 2) // 2
    m_k = ms[k]
    if ndim == 1:
        return tuple(sorted(-da for da in range(-r, r + 1)))
    return tuple(sorted(-(da * m_k + db)
                        for da in range(-r, r + 1)
                        for db in range(-r, r + 1)))


# ---------------------------------------------------------------------------
# Cycle
# ---------------------------------------------------------------------------

def v_cycle_grid(h: GridHierarchy, f: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """One V-cycle with structured-grid transfers (same recursion as
    amg.v_cycle / reference VCycleManager.py:31-62)."""

    def run(k, f_k, x_k):
        if k == 0:
            return h.A0_inv.to(f_k.dtype) @ f_k
        lev = h.levels[k]
        x_k = _smooth(lev, h.smoother, x_k, f_k, h.nu_pre)
        r = f_k - matvec(lev.A_dev, x_k)
        f_c = grid_restrict(r, h.ndim, h.ms[k], h.ms[k - 1])
        del r
        x_c = run(k - 1, f_c, torch.zeros_like(f_c))
        x_k = x_k + grid_prolong(x_c, h.ndim, h.ms[k - 1], h.ms[k])
        x_k = _smooth(lev, h.smoother, x_k, f_k, h.nu_post)
        return x_k

    return run(h.n_levels - 1, f, x)


def grid_vc_apply(num_iters: int):
    """apply(state, r): ``num_iters`` grid V-cycles from a zero start —
    the GMG-as-preconditioner application."""

    def apply(state: GridHierarchy, r: torch.Tensor) -> torch.Tensor:
        x = torch.zeros_like(r)
        for _ in range(num_iters):
            x = v_cycle_grid(state, r, x)
        return x

    return apply
