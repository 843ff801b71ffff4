"""Geometric multigrid over a uniform refinement sequence.

Port of ``pysolvers_tpu/linear/gmg.py`` (capability parity with the
reference's stashed GMG intent, ``stash/GMGVCycleSolver.py:16-28``: a
V-cycle solver whose hierarchy comes from a mesh refinement sequence).

The geometric part is host setup, copied from the JAX package: linear and
bilinear interpolation on uniformly refined 1-D/2-D Dirichlet grids
(``interp_1d``, ``interp_2d``), full-weighting restriction (the
row-normalized transpose, ``make_restriction(P)``) and Galerkin coarse
operators R·(A·P) (``build_gmg_hierarchy``).  The produced ``MLHierarchy``
feeds either the sparse-transfer executor of the AMG module
(``build_device_hierarchy`` + ``v_cycle``) or the structured-grid executor
(``gmg_grid.py``: DIA stencil levels, strided-slice transfers, kernel K6 on
grids of m >= 4096).

What the JAX package chose by ``jax.default_backend()`` is chosen here by
the device: ``galerkin="auto"`` probes on the device on CUDA and builds on
the host on the CPU.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ..core import SolverConfig
from ..sparse.device import DiaMatrix, numpy_dtype, resolve_device
from ..sparse.host import HostCSR
from ..utils.timing import Timer, traced
from .amg import (AMGVCycle, AMGVCycleSolver, MLHierarchy,
                  build_device_hierarchy, make_restriction, v_cycle)
from .preconditioner import Preconditioner, PreconditionerType


def interp_1d(m_fine: int, m_coarse: int) -> HostCSR:
    """Linear interpolation P: coarse interior points → fine interior
    points on [0, 1] Dirichlet grids with m interior points per level
    (m_fine = 2·m_coarse + 1, element count doubles per refinement)."""
    if m_fine != 2 * m_coarse + 1:
        raise ValueError(f"m_fine={m_fine} != 2*m_coarse+1 "
                         f"(m_coarse={m_coarse})")
    j = np.arange(1, m_fine + 1)           # fine interior indices, 1-based
    even = j[j % 2 == 0]
    odd = j[j % 2 == 1]
    # coincident points: fine 2i ↔ coarse i
    rows = [even - 1]
    cols = [even // 2 - 1]
    vals = [np.ones(len(even))]
    # midpoints: fine 2i+1 = (coarse i + coarse i+1)/2; boundary terms drop
    for nb in (odd // 2, odd // 2 + 1):    # left / right coarse neighbor
        keep = (nb >= 1) & (nb <= m_coarse)
        rows.append(odd[keep] - 1)
        cols.append(nb[keep] - 1)
        vals.append(np.full(keep.sum(), 0.5))
    return HostCSR.from_coo(np.concatenate(rows), np.concatenate(cols),
                            np.concatenate(vals), (m_fine, m_coarse))


def _kron_coo(A: HostCSR, B: HostCSR) -> HostCSR:
    """Sparse Kronecker product (vectorized COO)."""
    ra, ca, va = A.to_coo()
    rb, cb, vb = B.to_coo()
    rows = (ra[:, None] * B.shape[0] + rb[None, :]).ravel()
    cols = (ca[:, None] * B.shape[1] + cb[None, :]).ravel()
    vals = (va[:, None] * vb[None, :]).ravel()
    return HostCSR.from_coo(rows, cols, vals,
                            (A.shape[0] * B.shape[0],
                             A.shape[1] * B.shape[1]))


def interp_2d(m_fine: int, m_coarse: int) -> HostCSR:
    """Bilinear interpolation on an m×m interior-point Dirichlet grid —
    the tensor product of two 1-D linear interpolations."""
    P1 = interp_1d(m_fine, m_coarse)
    return _kron_coo(P1, P1)


def refinement_ms(m_fine: int, num_levels: int) -> Sequence[int]:
    """Interior-point counts fine→coarse; each coarsening halves the
    element count (m → (m-1)/2)."""
    ms = [m_fine]
    for _ in range(num_levels - 1):
        m = ms[-1]
        if m % 2 == 0 or m < 3:
            raise ValueError(
                f"grid with m={m} interior points cannot be uniformly "
                f"coarsened (need odd m ≥ 3); pick m = 2^L·(m0+1)-1")
        ms.append((m - 1) // 2)
    return ms


def build_gmg_hierarchy(A: HostCSR, num_levels: int,
                        dims: Tuple[int, ...]) -> MLHierarchy:
    """Galerkin matrix sequence over the uniform refinement hierarchy
    (reference stash/GMGVCycleSolver.py:27-28 ``makeMatrixSequence``):
    A_{k-1} = R·(A_k·P), restriction = row-normalized Pᵀ (full weighting).

    ``dims``: grid shape in interior points — (m,) for 1-D, (m, m) for
    2-D; A must be the fine-grid operator with matching size.
    """
    if len(dims) == 1:
        make_p = interp_1d
        n_of = lambda m: m                              # noqa: E731
    elif len(dims) == 2:
        if dims[0] != dims[1]:
            raise ValueError("2-D GMG needs a square m×m grid")
        make_p = interp_2d
        n_of = lambda m: m * m                          # noqa: E731
    else:
        raise ValueError("dims must be (m,) or (m, m)")
    if A.shape[0] != n_of(dims[0]):
        raise ValueError(f"A is {A.shape[0]}×{A.shape[0]} but dims={dims} "
                         f"implies n={n_of(dims[0])}")

    ms = refinement_ms(dims[0], num_levels)
    mats = [A]
    Ps = []
    Rs = []
    for k in range(1, num_levels):
        P = make_p(ms[k - 1], ms[k])
        R = make_restriction(P)
        A_c = R.matmat(mats[-1].matmat(P))
        mats.append(A_c)
        Ps.append(P)
        Rs.append(R)
    mats.reverse()
    Ps.reverse()
    Rs.reverse()
    return MLHierarchy(mats, Ps, Rs)


class GMGVCycle(AMGVCycle):
    """Factory for the geometric-MG V-cycle solver (reference
    stash/GMGVCycleSolver.py:16-21 defaults: nuPre=nuPost=3).

    ``dims`` names the structured grid ((m,) or (m, m) interior points);
    everything else — smoothers, device cycle, matrix_format — is shared
    with the AMG solver, plus ``matrix_format="grid"`` (the structured-grid
    executor, gmg_grid.py).
    """

    matrix_formats = ("auto", "bws", "grid")

    def __init__(self, control: Optional[SolverConfig] = None,
                 dims: Tuple[int, ...] = None, num_levels: int = 2,
                 nu_pre: int = 3, nu_post: int = 3, smoother: str = "auto",
                 matrix_format: str = "auto", mesh=None, device=None):
        if dims is None:
            raise ValueError("GMGVCycle needs dims=(m,) or (m, m)")
        super().__init__(control, num_levels=num_levels, nu_pre=nu_pre,
                         nu_post=nu_post, smoother=smoother,
                         matrix_format=matrix_format, mesh=mesh,
                         device=device)
        self.dims = tuple(int(d) for d in dims)

    def make_solver(self):
        return GMGVCycleSolver(self)

    makeSolver = make_solver


class GMGVCycleSolver(AMGVCycleSolver):
    def _build_mlh(self, A_host: HostCSR) -> MLHierarchy:
        return build_gmg_hierarchy(A_host, self.typ.num_levels,
                                   self.typ.dims)

    def _build_device(self, mlh: MLHierarchy, dtype):
        """``matrix_format="grid"`` lowers onto the structured-grid
        executor (gmg_grid.py) — DIA stencil levels and strided-slice
        transfers."""
        if self.typ.matrix_format != "grid":
            return super()._build_device(mlh, dtype)
        from .gmg_grid import build_grid_hierarchy
        return build_grid_hierarchy(
            None, self.typ.num_levels, self.typ.dims,
            smoother=self.typ.smoother, nu_pre=self.typ.nu_pre,
            nu_post=self.typ.nu_post,
            dtype=numpy_dtype(dtype) if dtype is not None else np.float64,
            mlh=mlh, device=self.device)


class GMGPreconditionerType(PreconditionerType):
    """Geometric MG as a preconditioner: fixed number of V-cycles per
    application (the GMG counterpart of AMGPreconditionerType /
    reference AMGPreconditioner.py:8-51 semantics).

    ``executor="grid"`` (default) lowers onto the structured-grid executor
    (gmg_grid.py); ``executor="sparse"`` uses the generic sparse-transfer
    device hierarchy.  ``galerkin`` (grid executor): "host" (host SpGEMM),
    "device" (probed on the device from the solver's DIA operator, which
    then uploads nothing) or "auto" ("device" on CUDA or where no host
    matrix comes, "host" otherwise).  The hierarchy lives on the device
    the solver passes to ``form``.

    Probed from the solver's DIA operator, the hierarchy's fine level
    multiplies by that operator's own table (K1), so the solver and the
    V-cycle hold one fine table; the probed levels of m >=
    ``gmg_grid.GRID_KERNEL_MIN_M`` are grid tables (K6).  The grid
    executor with a "device" Galerkin needs no host matrix: a solver may
    be handed the device ``DiaMatrix`` alone (``forms_from_device``).

    Each apply counts "gmg.applies"; while the profiler runs it is the
    span "gmg.apply", with ``v_cycle_grid``'s "gmg.level.<k>" inside.
    """

    side = "both"

    def __init__(self, dims: Tuple[int, ...], num_iters: int = 5,
                 num_levels: int = 2, nu_pre: int = 2, nu_post: int = 2,
                 smoother: str = "jacobi", executor: str = "grid",
                 side: str = "both", galerkin: str = "auto"):
        if executor not in ("grid", "sparse"):
            raise ValueError(f"executor must be 'grid' or 'sparse', got "
                             f"{executor!r}")
        self.dims = tuple(int(d) for d in dims)
        self.num_iters = num_iters
        self.num_levels = num_levels
        self.nu_pre = nu_pre
        self.nu_post = nu_post
        self.smoother = smoother
        self.executor = executor
        self.side = side
        self.galerkin = galerkin

    def forms_from_device(self, A_dev) -> bool:
        return self.executor == "grid" and isinstance(A_dev, DiaMatrix)

    def _hierarchy(self, A_host: Optional[HostCSR], dtype, A_dev, device):
        if self.executor == "grid":
            from .gmg_grid import (build_grid_hierarchy,
                                   build_grid_hierarchy_device)
            gal = self.galerkin
            if gal == "auto":
                gal = ("device" if device.type == "cuda" or A_host is None
                       else "host")
            if gal == "device" and isinstance(A_dev, DiaMatrix):
                # operator already on the device: probe straight from it —
                # the hierarchy build uploads nothing, and its fine level
                # is the solver's own table
                return build_grid_hierarchy_device(
                    A_dev, self.num_levels, self.dims,
                    smoother=self.smoother, nu_pre=self.nu_pre,
                    nu_post=self.nu_post, share_fine=True)
            if A_host is None and gal == "host":
                raise ValueError(
                    "GMGPreconditionerType(galerkin='host') builds its "
                    "coarse operators from a HostCSR matrix; pass the host "
                    "matrix (or a (host, device) pair) to solve(), or use "
                    "galerkin='device' or 'auto' with a device DiaMatrix")
            return build_grid_hierarchy(
                A_host, self.num_levels, self.dims,
                smoother=self.smoother, nu_pre=self.nu_pre,
                nu_post=self.nu_post, dtype=np.dtype(dtype),
                galerkin=gal, device=device)
        mlh = build_gmg_hierarchy(A_host, self.num_levels, self.dims)
        return build_device_hierarchy(mlh, self.smoother, self.nu_pre,
                                      self.nu_post, dtype=dtype,
                                      device=device)

    def form(self, A_host: Optional[HostCSR], A_dev=None,
             device=None) -> Preconditioner:
        device = resolve_device(device)
        dtype = (A_host.data.dtype if A_host is not None
                 else numpy_dtype(A_dev.dtype))
        h = self._hierarchy(A_host, dtype, A_dev, device)
        num_iters = self.num_iters

        def apply(v):
            Timer.count("gmg.applies")
            with traced("gmg.apply"):
                x = v.new_zeros(v.shape)
                for _ in range(num_iters):
                    x = v_cycle(h, v, x)
                return x

        prec = self._wrap(apply)
        prec.state = h
        return prec
