"""Block preconditioners for block-structured (BdiaMatrix) operators.

Port of ``pysolvers_tpu/linear/block_precond.py``: the
``PreconditionerType.form`` contract (reference PySolvers/Linear/
PreconditionerType.py:4-11, consumed at PCGSolver.py:92-94) for the planar
block-DIA format.  Every apply stays in the planar (dof-major) layout.

* ``BlockJacobiBdiaPreconditionerType`` — M = blockdiag(D_i); the D_i are
  inverted on the planes' device by a batched Gauss-Jordan without
  pivoting (``batched_inverse``, ported as it is rather than
  ``torch.linalg.inv`` so the numbers match the JAX package's), stored as
  (b, b, nb) planes and applied as one einsum (``_block_apply``; plain
  torch, as the JAX package computes it outside any kernel).
  ``block_jacobi_bdia_matrix`` gives the same inverse as a D = 1
  ``BdiaMatrix``, which the lockstep multi-RHS solve applies through
  kernel K5.
* ``BlockMGBdiaPreconditionerType`` — b independent scalar SA-AMG
  hierarchies, one per dof subsystem (``bdia_dof_subsystem``), built with
  the port's ``build_sa_hierarchy``/``build_device_hierarchy``: BWS level
  operators in f32 (kernel K2), the auto formats in f64 (K1 on each
  dof's banded fine level).
* ``BlockChebyshevBdiaPreconditionerType`` — degree-k Chebyshev on the
  block-Jacobi-scaled operator; every product is K4.

The ``traced`` fields (JAX passed the state as jit arguments) and the
per-(num_iters, b, nb) apply-function cache (it kept JAX's jit caches
warm) have no counterpart.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import matvec
from ..ops.cuda_graph import GraphedApply
from ..sparse.bdia import BdiaMatrix
from ..sparse.device import numpy_dtype
from ..sparse.host import HostCSR
from ..utils.timing import Timer, traced
from .amg import (_replays_as_graph, build_device_hierarchy,
                  build_sa_hierarchy, v_cycle)
from .preconditioner import Preconditioner, PreconditionerType


def batched_inverse(Bs: torch.Tensor, ridge: float = 0.0) -> torch.Tensor:
    """Invert a batch of small dense blocks (nb, b, b) by Gauss-Jordan
    without pivoting (exact for the SPD/diagonally-dominant diagonal
    blocks this feeds on; ``ridge`` adds r·I first for safety)."""
    nb, b, _ = Bs.shape
    eye = torch.eye(b, dtype=Bs.dtype, device=Bs.device)
    if ridge:
        Bs = Bs + ridge * eye
    M = torch.cat([Bs, eye.expand(nb, b, b)], dim=-1)
    for j in range(b):
        piv_row = M[:, j, :]                           # (nb, 2b)
        pj = piv_row[:, j:j + 1]
        pj = torch.where(pj == 0, torch.ones_like(pj), pj)  # singular guard
        piv_row = piv_row / pj
        M = M - M[:, :, j:j + 1] * piv_row[:, None, :]
        M[:, j, :] = piv_row             # M is a fresh tensor: no alias
    return M[:, :, b:]


def _block_apply(Binv_pl: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """y = blockdiag(D_i)^{-1} v in planar layout.  Binv_pl is (b, b, nb)
    with Binv_pl[p, q, i] = (D_i^{-1})[p, q]; v is planar (b·nb,) or
    (b·nb, k)."""
    b, _, nb = Binv_pl.shape
    B = Binv_pl.to(v.dtype)
    if v.ndim == 1:
        return torch.einsum("pqi,qi->pi", B,
                            v.reshape(b, nb)).reshape(b * nb)
    k = v.shape[1]
    return torch.einsum("pqi,qik->pik", B,
                        v.reshape(b, nb, k)).reshape(b * nb, k)


def block_jacobi_bdia_matrix(A: BdiaMatrix) -> BdiaMatrix:
    """blockdiag(D_i)^{-1} AS a BdiaMatrix (offsets=(0,)), so the lockstep
    multi-RHS solve applies block-Jacobi through kernel K5, like the
    operator."""
    Binv = batched_inverse(A.diag_blocks())           # (nb, b, b)
    # planes[q, p, i] = (D_i^{-1})[p, q]  (BdiaMatrix plane convention)
    planes = Binv.permute(2, 1, 0).to(A.dtype)
    planes = torch.nn.functional.pad(planes, (0, A.nb_pad - A.nb))
    return BdiaMatrix(planes.contiguous(), (0,),
                      torch.zeros(1, dtype=torch.int32, device=A.device),
                      A.shape, A.b)


def _bdia_operand(A_host, A_dev) -> BdiaMatrix:
    A = A_dev if isinstance(A_dev, BdiaMatrix) else A_host
    if not isinstance(A, BdiaMatrix):
        raise ValueError("block preconditioners need a BdiaMatrix")
    return A


class BlockJacobiBdiaPreconditionerType(PreconditionerType):
    """M = blockdiag(D_i) for a BdiaMatrix — the planar analog of point
    Jacobi; setup is one batched Gauss-Jordan on the planes' device."""

    def __init__(self, side: str = "right"):
        self.side = side

    def form(self, A_host=None, A_dev: BdiaMatrix = None,
             device=None) -> Preconditioner:
        A = _bdia_operand(A_host, A_dev)
        Binv = batched_inverse(A.diag_blocks())        # (nb, b, b)
        Binv_pl = Binv.permute(1, 2, 0).contiguous()   # (b[p], b[q], nb)
        return self._wrap(lambda v: _block_apply(Binv_pl, v))


def bdia_dof_subsystem(A: BdiaMatrix, p: int) -> HostCSR:
    """Scalar per-dof subsystem S_p (HostCSR): S_p[i, i+off] =
    A[i·b+p, (i+off)·b+p] — the dof-p diagonal of every block plane
    (planes[d·b+p, p, i]).  Only those D plane rows leave the device."""
    b, nb = A.b, A.nb
    idx = torch.tensor([d * b + p for d in range(len(A.offsets))],
                       device=A.device)
    pl = A.planes[idx, p, :].cpu().numpy()            # (D, nb_pad)
    rows_l, cols_l, vals_l = [], [], []
    for d, off in enumerate(A.offsets):
        i = np.arange(nb)
        j = i + off
        ok = (j >= 0) & (j < nb)
        rows_l.append(i[ok])
        cols_l.append(j[ok])
        vals_l.append(pl[d, i[ok]])
    return HostCSR.from_coo(np.concatenate(rows_l), np.concatenate(cols_l),
                            np.concatenate(vals_l), (nb, nb))


class BlockMGBdiaPreconditionerType(PreconditionerType):
    """dof-decoupled multigrid for a BdiaMatrix — the strong planar
    preconditioner.  The planar layout is dof-major, so each dof's values
    are a contiguous nb-stream: b independent scalar SA hierarchies (one
    per subsystem S_p) apply with no transposes — slice the vector, run
    V-cycles, stack.  The inter-dof coupling left out of M is what CG
    handles, so iterations drop from O(√κ(A)) to O(coupling strength).

    On one CUDA device the b fields' V-cycles of an apply are served by
    one CUDA graph per input signature (``ops/cuda_graph.py::
    GraphedApply``, the rule of ``AMGPreconditionerType``: the hierarchies'
    Jacobi sweeps make no host read): the first call runs eagerly, the
    second captures, every later call replays.  The CPU runs every apply
    eagerly.

    Timers: "bdia.bmg_setup" (the b builds, always on); every apply counts
    "bmg.applies" (always on), graph launches "bmg.graph_captures" and
    "bmg.graph_replays" (the capturing call included); while the profiler
    runs an apply is the span "bmg.apply", and an eager one holds one
    "bmg.field" per field's V-cycles (a replay visits no field on the
    host; nothing is recorded with the profiler off)."""

    def __init__(self, num_iters: int = 1, num_levels: int = 3,
                 side: str = "right"):
        self.num_iters = num_iters
        self.num_levels = num_levels
        self.side = side

    def form(self, A_host=None, A_dev: BdiaMatrix = None,
             device=None) -> Preconditioner:
        A = _bdia_operand(A_host, A_dev)
        dtype = numpy_dtype(A.dtype)
        # BWS level operators in f32 (K2), the auto formats in f64
        fmt = "bws" if dtype == np.float32 else "auto"
        hierarchies = []
        with Timer("bdia.bmg_setup"):
            for p in range(A.b):
                S_p = bdia_dof_subsystem(A, p)
                S_p = HostCSR(S_p.indptr, S_p.indices,
                              S_p.data.astype(dtype), S_p.shape)
                mlh = build_sa_hierarchy(S_p, self.num_levels)
                hierarchies.append(build_device_hierarchy(
                    mlh, smoother="jacobi", dtype=dtype, device=A.device,
                    matrix_format=fmt))
        b, nb, num_iters = A.b, A.nb, self.num_iters

        def cycles(v):
            vb = v.reshape(b, nb)
            zs = []
            for p, h in enumerate(hierarchies):
                with traced("bmg.field"):
                    r = vb[p].to(h.levels[-1].dinv.dtype)
                    x = torch.zeros_like(r)
                    for _ in range(num_iters):
                        x = v_cycle(h, r, x)
                    zs.append(x)
            return torch.stack(zs).reshape(b * nb).to(v.dtype)

        # the scalar AMG preconditioner's rule, for the b V-cycles at once
        run = (GraphedApply(cycles, "bmg", A.device)
               if all(_replays_as_graph(h, None) for h in hierarchies)
               else cycles)

        def apply(v):
            Timer.count("bmg.applies")
            with traced("bmg.apply"):
                return run(v)

        prec = self._wrap(apply)
        prec.state = tuple(hierarchies)
        return prec


class BlockChebyshevBdiaPreconditionerType(PreconditionerType):
    """Degree-k Chebyshev polynomial on the block-Jacobi-scaled operator
    B^{-1}A over [lmax/eig_ratio, lmax] — products only (K4 does the
    work), planar."""

    def __init__(self, degree: int = 3, eig_ratio: float = 30.0,
                 side: str = "right", power_iters: int = 15):
        self.degree = degree
        self.eig_ratio = eig_ratio
        self.side = side
        self.power_iters = power_iters

    def form(self, A_host=None, A_dev: BdiaMatrix = None,
             device=None) -> Preconditioner:
        A = _bdia_operand(A_host, A_dev)
        Binv_pl = batched_inverse(A.diag_blocks()).permute(1, 2, 0)
        # power iteration for lmax(B^{-1}A) — setup, one host read each
        rng = np.random.default_rng(42)
        v = torch.as_tensor(rng.random(A.shape[0]), dtype=A.dtype,
                            device=A.device)
        lam = 1.0
        for _ in range(self.power_iters):
            w = _block_apply(Binv_pl, matvec(A, v))
            lam = float(torch.linalg.norm(w))
            if lam == 0:
                lam = 1.0
                break
            v = w / lam
        lmax = lam * 1.05
        lmin = lmax / self.eig_ratio
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        degree = self.degree

        def apply(r):
            z = torch.zeros_like(r)
            p = _block_apply(Binv_pl, r) / theta
            z = z + p
            rho = delta / theta
            for _ in range(degree - 1):
                res = _block_apply(Binv_pl, r - matvec(A, z))
                rho_new = 1.0 / (2.0 * theta / delta - rho)
                p = rho_new * rho * p + (2.0 * rho_new / delta) * res
                z = z + p
                rho = rho_new
            return z

        return self._wrap(apply)
