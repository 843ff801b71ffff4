"""SA setup with the construction products built on the device.

Port of the single-device half of ``pysolvers_tpu/parallel/amg_setup.py``.
The host setup (``linear/amg.py::build_sa_hierarchy``) forms the smoothed
prolongator and the Galerkin triple product by host SpGEMM.  Here only the
O(nnz) aggregation runs on the host; the products are dense device work:

* the tentative prolongator P̂ is one-hot (n, nc): SA gives every row one
  aggregate, so the dense-tall form is exact;
* P = P̂ − ω·D_f⁻¹·(A_f·P̂), one SpMM of the filtered matrix;
* AP = A·P, and A_c = Pᵀ·AP, one dense matrix product;
* R = Pᵀ, not row-normalised (``_setup_products``);
* the coarsest operator is inverted on the device.

What is stored is sparse: P, R = Pᵀ and the operators of the levels
between the finest and the coarsest are kept as the device matrices of
their exact nonzeros (``_host_nonzeros``: DIA where banded, else ELL, the
host build's formats), so a V-cycle reads O(nnz) bytes, not the dense
n·nc of the build.  No value is dropped or rounded: outside its pattern
a product of the build is an exact zero.  The coarsest level keeps only
its inverse (``A_dev`` is None there, as in the host build).

Memory gate: dense P is n·nc·itemsize bytes; the build raises
``DenseGateError`` (a ValueError) above ``max_bytes``, where the host
SpGEMM hierarchy (which scales in nnz) is the route.  Where it refuses
the finest level, the error carries that level's strength mask and
aggregates (``level0``), which the host build takes instead of forming
them again.

Exactness: the products run with TF32 off (``_exact_matmuls``), as the
JAX package computes them at ``precision=HIGHEST``: rounded operands in a
construction product break the V-cycle's consistency as a PCG
preconditioner.  The sparse products (``_spmm``) add their terms slot by
slot (DIA: diagonal by diagonal) as elementwise multiply-adds over a block
of columns, so no (n, K, nc) gather is formed and a column's result does
not depend on how the columns are blocked.

``mesh=`` (JAX ``:128-187``): the fine level is padded with unit-diagonal
rows to whole slabs (lcm(8, d) rows per step, or the solver's ``n_pad``)
and row-sharded for the products.  A rank forms P̂ and the filtered
product on its rows over a one-hop window of the band, exchanges P's
edge rows with its neighbours for A·P, and the contraction over the rows
A_c = Σ_ranks P_rᵀ·(A·P)_r is one ``all_reduce`` (``_setup_products_mesh``);
the fine band must fit in a slab.  The stored fine operator, its
smoother diagonal and P's rows are the rank's slab, R the ranks' summed
local product (``linear/amg.py::sharded_transfers``); the coarse levels
are replicated.  The memory gate counts the whole dense P, as in the JAX
package.

Not ported: the JAX package's jit cache of the products (a compile-time
workaround).
The coarse inverse is ``torch.linalg.inv`` in f64, cast to the build's
dtype (the JAX ``ops/dense_inverse.py`` is a TPU workaround), so an f32
build's inverse is the f64 inverse of its f32 operator, rounded once.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from .. import api
from ..linear.amg import (DEVICE_SMOOTHERS, DeviceHierarchy, DeviceLevel,
                          build_aggregates, filtered_matrix,
                          strength_neighbors)
from ..ops.spmv import dia_spmm
from ..sparse.bws import lower_to_csr
from ..sparse.device import (DiaMatrix, EllMatrix, resolve_device,
                             torch_dtype)
from ..sparse.host import HostCSR
from ..utils.timing import Timer

# bytes of one (n, columns) block of a sparse product's temporaries
CHUNK_BYTES = 1 << 30


class DenseGateError(ValueError):
    """The dense prolongator of a level is over ``max_bytes``.
    ``level0``: (strength, aggregates) of the finest level where the gate
    refused there, else None."""

    def __init__(self, msg: str, level0=None):
        super().__init__(msg)
        self.level0 = level0


def pad_csr_identity(H: HostCSR, n_pad: int) -> HostCSR:
    """Extend a square CSR with unit-diagonal rows up to n_pad."""
    n = H.shape[0]
    if n_pad == n:
        return H
    rows, cols, vals = H.to_coo()
    extra = np.arange(n, n_pad)
    return HostCSR.from_coo(
        np.concatenate([rows, extra]), np.concatenate([cols, extra]),
        np.concatenate([vals, np.ones(n_pad - n, dtype=vals.dtype)]),
        (n_pad, n_pad), sum_duplicates=False)


def _device_op(A_host: HostCSR, dtype, device):
    """The device matrix of a host level: DIA when banded, ELL otherwise."""
    return api.as_device_matrix(A_host, dtype=dtype, device=device)[1]


def _host_nonzeros(T: torch.Tensor) -> HostCSR:
    """The host CSR of a dense tensor's nonzeros, values unchanged."""
    idx = T.nonzero()
    vals = T[idx[:, 0], idx[:, 1]].cpu().numpy()
    idx = idx.cpu().numpy()
    return HostCSR.from_coo(idx[:, 0], idx[:, 1], vals, tuple(T.shape),
                            sum_duplicates=False)


def _ell_spmm_slots(A: EllMatrix, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for an (n_cols, c) block: one gather of X's rows per ELL
    slot, added in slot order."""
    Xp = torch.zeros((max(A.n_cols_pad, A.n_cols + 1), X.shape[1]),
                     dtype=X.dtype, device=X.device)
    Xp[: A.n_cols] = X[: A.n_cols]
    Y = torch.zeros((A.data.shape[0], X.shape[1]), dtype=X.dtype,
                    device=X.device)
    for k in range(A.data.shape[1]):
        Y.addcmul_(A.data[:, k, None], Xp[A.cols[:, k]])
    return Y[: A.n_rows]


def _spmm(A, X: torch.Tensor, chunk: int) -> torch.Tensor:
    """A @ X for a sparse device matrix, ``chunk`` columns of X at a time
    (each column's terms in the same order whatever ``chunk`` is); a dense
    A is one matrix product."""
    if isinstance(A, torch.Tensor):
        return A @ X
    if not isinstance(A, (DiaMatrix, EllMatrix)):
        raise TypeError(f"no construction product for {type(A).__name__}")
    Y = torch.empty((A.shape[0], X.shape[1]), dtype=X.dtype, device=X.device)
    for j in range(0, X.shape[1], chunk):
        Xj = X[:, j: j + chunk]
        Y[:, j: j + chunk] = (dia_spmm(A, Xj) if isinstance(A, DiaMatrix)
                              else _ell_spmm_slots(A, Xj))
    return Y


def _chunk_columns(n: int, dtype, chunk_bytes: int) -> int:
    return max(1, chunk_bytes // max(1, n * torch.empty(
        0, dtype=dtype).element_size()))


@contextlib.contextmanager
def _exact_matmuls():
    """TF32 off for the products (the JAX package's ``precision=HIGHEST``),
    whatever the caller set; restored after."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def _setup_products(A_dev, Af_dev, dinv_f: torch.Tensor, agg: torch.Tensor,
                    *, nc: int, omega: float,
                    chunk_bytes: int = CHUNK_BYTES):
    """Smoothed P, R and dense A_c of one level on ``dinv_f``'s device.

    R = Pᵀ UNNORMALIZED, as ``amg.sa_coarsen``: the row-sum scaled
    variant makes A_c non-symmetric on unstructured aggregates, which
    breaks the V-cycle as an SPD PCG preconditioner.  R is P's transposed
    view, not a copy.  P̂ is made by a scatter in the build's dtype, a
    block of columns at a time."""
    dtype, device = dinv_f.dtype, dinv_f.device
    n = agg.shape[0]
    assert not torch.backends.cuda.matmul.allow_tf32
    chunk = _chunk_columns(n, dtype, chunk_bytes)
    P = torch.empty((n, nc), dtype=dtype, device=device)
    for j in range(0, nc, chunk):
        c = min(chunk, nc - j)
        # one-hot columns j..j+c of P̂: a row of another aggregate scatters
        # its 0 into a clamped column
        hit = ((agg >= j) & (agg < j + c)).to(dtype)
        P_hat = torch.zeros((n, c), dtype=dtype, device=device).scatter_(
            1, (agg - j).clamp(0, c - 1)[:, None], hit[:, None])
        P[:, j: j + c] = P_hat - omega * (dinv_f[:, None]
                                          * _spmm(Af_dev, P_hat, c))
    AP = _spmm(A_dev, P, chunk)
    A_c = P.T @ AP
    return P, P.T, A_c


def _window_op(H: HostCSR, lo: int, slab: int, h: int, dtype, device):
    """The rows [lo, lo + slab) of a square host matrix over the column
    window [lo - h, lo + slab + h), as a device matrix."""
    from ..linear.amg import row_slice
    R = row_slice(H, lo, lo + slab)
    W = HostCSR(R.indptr, (R.indices.astype(np.int64) - (lo - h)).astype(
        np.int32), R.data, (slab, slab + 2 * h))
    return _device_op(W, dtype, device)


def _setup_products_mesh(A_win, Af_win, dinv_f: torch.Tensor,
                         agg_win: torch.Tensor, *, nc: int, omega: float,
                         h: int, mesh, chunk_bytes: int = CHUNK_BYTES):
    """The rank's rows of the smoothed P (slab, nc) and the replicated
    dense A_c = Pᵀ·A·P, from its window operators (``_window_op``) and the
    aggregates of its window rows (-1 outside the matrix)."""
    from .mesh import all_reduce, halo_exchange
    dtype, device = dinv_f.dtype, dinv_f.device
    slab = dinv_f.shape[0]
    nw = agg_win.shape[0]
    assert not torch.backends.cuda.matmul.allow_tf32
    chunk = _chunk_columns(nw, dtype, chunk_bytes)
    P = torch.empty((slab, nc), dtype=dtype, device=device)
    for j in range(0, nc, chunk):
        c = min(chunk, nc - j)
        hit = ((agg_win >= j) & (agg_win < j + c)).to(dtype)
        P_hat = torch.zeros((nw, c), dtype=dtype, device=device).scatter_(
            1, (agg_win - j).clamp(0, c - 1)[:, None], hit[:, None])
        P[:, j: j + c] = P_hat[h: h + slab] - omega * (
            dinv_f[:, None] * _spmm(Af_win, P_hat, c))
    lo_rows, hi_rows = halo_exchange(mesh, P, h, h)
    AP = _spmm(A_win, torch.cat([lo_rows, P, hi_rows]), chunk)
    return P, all_reduce(mesh, P.T @ AP)


def _mesh_level0(A_host: HostCSR, Af: HostCSR, d_f: np.ndarray,
                 agg: np.ndarray, nc: int, omega: float, slab: int, dtype,
                 mesh):
    """The sharded finest level's products (``_setup_products_mesh``):
    windows one band wide each way, which must fit in a slab."""
    rows, cols, _ = A_host.to_coo()
    band = int(np.abs(rows - cols).max()) if len(rows) else 0
    if band > slab:
        raise ValueError(f"the fine band {band} exceeds the slab {slab}: "
                         "one neighbour hop does not reach (build on the "
                         "host)")
    h = band
    lo = mesh.rank * slab
    dev = mesh.device
    idx = np.arange(lo - h, lo + slab + h)
    agg_win = np.where((idx >= 0) & (idx < len(agg)),
                       agg[np.clip(idx, 0, len(agg) - 1)], -1)
    return _setup_products_mesh(
        _window_op(A_host, lo, slab, h, dtype, dev),
        _window_op(Af, lo, slab, h, dtype, dev),
        torch.as_tensor((1.0 / d_f[lo: lo + slab]).astype(dtype), device=dev),
        torch.as_tensor(agg_win, dtype=torch.int64, device=dev),
        nc=nc, omega=float(omega), h=h, mesh=mesh)


def _synchronize(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_distributed_hierarchy(A_host: HostCSR, mesh=None, *,
                                num_levels: int = 2, smoother: str = "jacobi",
                                nu_pre: int = 2, nu_post: int = 2,
                                base_tol: float = 0.08,
                                omega: float = 2.0 / 3.0,
                                dtype=np.float32,
                                max_bytes: int = 1 << 31,
                                fine_format: str = "auto",
                                device=None,
                                n_pad: Optional[int] = None
                                ) -> DeviceHierarchy:
    """SA hierarchy with device-built construction products (see the
    module docstring) on ``device`` (None: the current CUDA device).

    ``smoother``: "jacobi" or "chebyshev"; any other raises a ValueError
    (GS and SGS need the host build's triangular-solve plans).

    ``fine_format``: the stored fine-level operator, the one every
    smoothing product of the V-cycle runs on (the construction products
    keep the DIA/ELL operator).  "bws" brings it into the BWS lane (kernel
    K2 on CUDA) by the rule every hierarchy's levels take
    (``sparse/bws.py::lower_to_csr``, ``group_rows`` 32): K2's layout where
    the JAX package's pack would take a window, the product operator where
    it would not; "auto" does so on CUDA (``api._bws_route``), in f32 and
    f64, and keeps the product operator on the CPU; any other value keeps
    the product operator.  The coarse inverse is taken on ``device`` (the
    JAX package's ``coarse_inverse="host"``, which no caller passes, is
    not ported).

    ``mesh``: a ``parallel.mesh.Mesh``; the fine level is padded to
    ``n_pad`` rows (default: a multiple of lcm(8, d)) and row-sharded on
    the rank's device (module docstring); ``device`` is the mesh's.

    Levels are coarsest first; P and R sit on the FINE level of each
    transfer (``v_cycle``: ``P_dev`` prolongates into its level, ``R_dev``
    restricts out of it).  A hierarchy of one level stores its dense
    operator; otherwise the coarsest level stores only ``A0_inv``.

    Timers: "amg.device_aggregate" (host aggregation and filtering),
    "amg.device_products" (the products, synchronized), "amg.device_sparse"
    (the stored transfers and operators), "amg.device_bws" (the fine
    level's lowering), "amg.device_inverse" (synchronized)."""
    if smoother not in DEVICE_SMOOTHERS:
        raise ValueError(f"distributed setup provides jacobi/chebyshev "
                         f"smoothing, not {smoother!r} (GS and SGS need "
                         "triangular solves; use the host path for them)")
    slab = None
    if mesh is not None:
        from ..linear.amg import mesh_rows
        from .mesh import check_mesh
        check_mesh(mesh)
        if fine_format == "bws":
            raise ValueError("fine_format='bws' is one-device; mesh= builds "
                             "keep the sharded operator")
        n_pad, slab = mesh_rows(A_host.shape[0], mesh, n_pad)
        # identity rows: the padded system restricts exactly to the
        # original coordinates for a zero-padded b
        A_host = pad_csr_identity(A_host, n_pad)
        device = mesh.device
    device = resolve_device(device)
    tdtype = torch_dtype(dtype)
    itemsize = np.dtype(dtype).itemsize

    levels = []          # built fine→coarse, reversed at the end
    A_cur_host: Optional[HostCSR] = A_host
    A_cur_dense: Optional[torch.Tensor] = None
    for lvl in range(num_levels - 1):
        tol = base_tol * (0.5 ** lvl)
        with Timer("amg.device_aggregate"):
            if A_cur_host is None:
                # below the second level the operator is the dense A_c;
                # aggregation needs its sparsity, so re-sparsify on the
                # host with a relative drop (the device product leaves
                # rounding noise where the exact product has zeros)
                A_np = A_cur_dense.cpu().numpy().astype(np.float64)
                A_cur_host = HostCSR.from_dense(
                    A_np, tol=1e-10 * float(np.abs(A_np).max() or 1.0))
            n = A_cur_host.shape[0]
            strength = strength_neighbors(A_cur_host, tol)
            agg = build_aggregates(A_cur_host, tol, strength=strength)
            nc = int(agg.max()) + 1 if n else 0
            if nc >= n or n <= 8:
                # coarsening stalled, or the level is already
                # direct-solve-sized: it becomes the coarsest
                break
            if n * nc * itemsize > max_bytes:
                raise DenseGateError(
                    f"dense prolongator {n}x{nc} exceeds max_bytes; use the "
                    "host-SpGEMM hierarchy (linear/amg.py) at this scale",
                    level0=(strength, agg) if lvl == 0 else None)
            Af = filtered_matrix(A_cur_host, tol, strength=strength)
        d = Af.diagonal()
        d = np.where(d == 0, 1.0, d)
        sharded = slab is not None and lvl == 0
        with Timer("amg.device_products"), _exact_matmuls():
            if sharded:
                P, A_c = _mesh_level0(A_cur_host, Af, d, agg, nc, omega,
                                      slab, dtype, mesh)
            else:
                dinv_f = torch.as_tensor((1.0 / d).astype(dtype),
                                         device=device)
                A_dev = (_device_op(A_cur_host, dtype, device)
                         if A_cur_dense is None else A_cur_dense)
                Af_dev = _device_op(Af, dtype, device)
                P, _, A_c = _setup_products(
                    A_dev, Af_dev, dinv_f,
                    torch.as_tensor(agg, dtype=torch.int64, device=device),
                    nc=nc, omega=float(omega))
            _synchronize(device)
        with Timer("amg.device_sparse"):
            P_host = _host_nonzeros(P)
            del P
            if sharded:
                from ..linear.amg import sharded_transfers
                from .mesh import shard_operator_rows
                P_dev, R_dev = sharded_transfers(P_host, mesh, dtype)
                A_store = shard_operator_rows(A_cur_host, mesh, slab, dtype)
            else:
                P_dev = _device_op(P_host, dtype, device)
                R_dev = _device_op(P_host.transpose(), dtype, device)
                A_store = A_dev if A_cur_dense is None else _device_op(
                    _host_nonzeros(A_dev), dtype, device)

        d_op = A_cur_host.diagonal()
        d_op = np.where(d_op == 0, 1.0, d_op)
        if sharded:
            d_op = d_op[mesh.rank * slab: (mesh.rank + 1) * slab]
        dinv_op = torch.as_tensor((1.0 / d_op).astype(dtype), device=device)
        cheb = None
        if smoother == "chebyshev":
            from ..linear.preconditioner import ChebyshevPreconditionerType
            lmax = ChebyshevPreconditionerType().estimate_lmax(A_cur_host)
            lmin = lmax / 30.0
            cheb = (0.5 * (lmax + lmin), 0.5 * (lmax - lmin))
        want_bws = not sharded and (fine_format == "bws"
                    or (fine_format == "auto" and lvl == 0
                        and api._bws_route(device)))
        if want_bws and A_cur_dense is None:
            with Timer("amg.device_bws"):
                # None where too unbanded: the product operator stays
                A_store = lower_to_csr(A_cur_host, dtype, device) or A_store
        levels.append(DeviceLevel(A_store, dinv_op, None, P_dev, R_dev,
                                  cheb))
        A_cur_host = None
        A_cur_dense = A_c

    if slab is not None and not levels:
        raise ValueError("a mesh hierarchy needs a coarsened level (its "
                         "coarsest level is replicated, its finest sharded)")
    # the coarsest level: the dense A_c, or the current host matrix where
    # no level was coarsened (num_levels=1, or a stall at the finest)
    A_c = (A_cur_dense if A_cur_dense is not None else torch.as_tensor(
        A_cur_host.to_dense().astype(dtype), device=device))
    with Timer("amg.device_inverse"):
        A0_inv = torch.linalg.inv(A_c.to(torch.float64)).to(tdtype)
        _synchronize(device)
    if levels:
        levels.append(DeviceLevel(None, None, None, None, None, None))
    else:
        d0 = torch.diagonal(A_c)
        d0 = torch.where(d0 == 0, torch.ones_like(d0), d0)
        levels.append(DeviceLevel(A_c, 1.0 / d0, None, None, None, None))
    levels.reverse()
    return DeviceHierarchy(levels, A0_inv, smoother, nu_pre, nu_post)
