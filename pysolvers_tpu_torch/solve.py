"""One-call convenience front end: ``pysolvers_tpu_torch.solve(A, b)``.

Port of the native-precision routes of ``pysolvers_tpu/solve.py``.  Picks
a method and preconditioner from the matrix's structure:

* symmetric (within tolerance) → PCG, else GMRES;
* small systems (n <= 500) → direct dense solve;
* preconditioner "auto": AMG for large SPD systems, IC(t) for medium SPD,
  ILUT for nonsymmetric.

Two routes run at native precision, and with ``precision="mixed"`` (f32
inner Krylov on the kernels, f64 refinement, ``linear/refine.py``):

* the scalar route on a HostCSR: CG or GMRES (``restart``, ``flexible``
  and ``orthog`` are forwarded to GMRES) with ``"none"``, ``"ic"``,
  ``"ilut"``, ``"amg"`` or ``"jacobi"``, and the direct solve;
* the block-DIA lane: ``solve(BdiaMatrix, b)`` with b of shape (n,) or
  (n, k), CG with ``"auto"`` (= ``"bjacobi"``), ``"none"``, ``"bcheb"``,
  ``"bmg"`` or ``"ic"`` (scalar IC(t) of the host CSR view, applied in
  node-major order between planar reorders), and GMRES for one
  right-hand side.  Every operator product is kernel K4 (single RHS) or K5
  (lockstep multi-RHS, which also applies block-Jacobi through K5).  An
  all-"auto" CG call on a large HostCSR with b×b block structure
  (``sparse/bdia.py::detect_block_size``) is packed and rerouted there.

Mixed precision on a HostCSR goes through the factories' route
(``api._solve_mixed``), with the solver kept in a small cache keyed on the
matrix's identity and a fingerprint of its values
(``_cached_mixed_solver``).  On a BdiaMatrix it runs ``ir_solve_dd`` with
K4 in f32 inside and K4 in f64 as the oracle (one right-hand side), and
for k right-hand sides ``cg_lockstep_rr`` (K5 for the operator and
block-Jacobi, f32; K5 f64 for the replacements) or, with the other
preconditioners, ``ir_solve_multi``.

k right-hand sides on a HostCSR (``_solve_multi``, b of shape (n, k)):
native CG runs ``cg_solve_multi`` and native GMRES ``gmres_solve_multi``
(lockstep restarts), one ``matmat`` per step for all columns (DIA: the
plain shift-and-FMA over the block; ELL: ``ell_spmm_torch``).  Mixed
precision runs on the factories' operators (``api.mixed_operators``: DIA
f32/f64, on CUDA the RCM-ordered BWS packs, K2 once per column, else ELL):
CG as one ``cg_lockstep_rr`` pass, GMRES as ``ir_solve_multi`` around
``gmres_solve_multi``.  The JAX package maps the single-vector
preconditioner over the columns with ``jax.vmap``; a kernel launch cannot
be mapped so, and the port applies it column by column — k applies, the
same result.  The direct solve, and GMRES with ``orthog``/``flexible`` or
a basis above 2³¹ bytes, solve the columns one by one through one solver
with the matrix and the preconditioner frozen
(``_solve_multi_column_loop``).

The block lane refuses GMRES with several right-hand sides (the JAX
package quietly runs CG there).  No route falls through to another.

``mesh=`` (a ``parallel.mesh.Mesh``; every rank makes the same call):
on a HostCSR the factories' mesh routes (``api.py``) with the
preconditioner formed on the rank's slabs — "auto" is "amg"
(``AMG(num_iters=2, num_levels=2)``) where the one-device route takes AMG, and
"amg" or "none" may be asked for; IC(t), ILUT and Jacobi have no mesh
form here and raise.  The block-DIA auto-route is skipped (JAX
``solve.py:125``).  k right-hand sides run lockstep over the mesh, and
mixed precision the mesh's refinement.  On a BdiaMatrix
(``_solve_bdia_mesh``, JAX ``solve.py:509-560``) the planes shard on the
block-row axis (``parallel/bdia.py``, K4 per product) with "bjacobi" (or
"auto") or "none", one right-hand side, CG or GMRES natively and CG with
residual replacement at mixed precision.  ``soln`` is the full vector on
every rank.
"""
from __future__ import annotations

import numpy as np
import torch

from .api import (CommonSolverArgs, DefaultDirect, GMRES, PCG,
                  as_device_matrix, mixed_operators)
from .core import SolveStatus, StopReason, make_status
from .linear.amg import AMGPreconditionerType
from .linear.block_precond import (BlockChebyshevBdiaPreconditionerType,
                                   BlockJacobiBdiaPreconditionerType,
                                   BlockMGBdiaPreconditionerType,
                                   block_jacobi_bdia_matrix)
from .linear.ilu import ICPreconditionerType, ILUTPreconditionerType
from .linear.krylov import (KrylovState, cg_lockstep_rr, cg_solve,
                            cg_solve_multi, cg_solve_multi_rows, cg_solve_rr,
                            gmres_solve, gmres_solve_multi)
from .linear.refine import ir_solve_dd, ir_solve_multi
from .linear.preconditioner import JacobiPreconditionerType, Preconditioner
from .ops.spmv import bdia_spmm_rows, bdia_spmv, matmat, per_vector
from .sparse.bdia import BdiaMatrix, detect_block_size
from .sparse.device import numpy_dtype, resolve_device, same_device
from .sparse.host import HostCSR
from .utils.cache import fifo_put


def _is_symmetric(A: HostCSR, rtol: float = 1e-10) -> bool:
    At = A.transpose()
    if A.nnz != At.nnz:
        return False
    if not (np.array_equal(A.indptr, At.indptr)
            and np.array_equal(A.indices, At.indices)):
        return False
    denom = np.abs(A.data).max() if A.nnz else 1.0
    return float(np.abs(A.data - At.data).max()) <= rtol * max(denom, 1e-300)


_PRECONDS = ("auto", "none", "ic", "ilut", "amg", "jacobi")
# the solve() keywords that go to GMRES (JAX solve.py:156-157)
_GMRES_KWARGS = ("restart", "flexible", "orthog")


def _precond_type(precond: str, method: str, n: int, mesh=None):
    """Resolve a precond name to a PreconditionerType (or None).  Unknown
    names raise — a typo must not silently run unpreconditioned.  On a
    ``mesh`` "auto" takes AMG where the one-device route does, and only
    "amg" and "none" have a mesh form."""
    if precond not in _PRECONDS:
        raise ValueError(f"unknown precond {precond!r}; "
                         f"expected one of {_PRECONDS}")
    if precond == "auto":
        if method == "cg":
            precond = "amg" if n >= 20_000 else "ic"
        else:
            precond = "ilut"
    if precond == "none":
        return None
    if mesh is not None:
        if precond != "amg":
            raise ValueError(
                f"precond {precond!r} has no mesh form: solve(..., mesh=) "
                "takes 'amg' or 'none' (the factories also take "
                "parallel.BlockJacobiILUPreconditionerType and "
                "parallel.PartitionAMGPreconditionerType)")
    if precond == "ic":
        return ICPreconditionerType()
    if precond == "ilut":
        return ILUTPreconditionerType()
    if precond == "amg":
        return AMGPreconditionerType(num_iters=2, num_levels=2)
    return JacobiPreconditionerType()


def solve(A, b, *, tau: float = 1e-8, maxiter: int = 1000,
          method: str = "auto", precond: str = "auto",
          precision: str = "native", detect_blocks: bool = True,
          device=None, **solver_kwargs) -> SolveStatus:
    """Solve A x = b on ``device`` (None: the current CUDA device, and a
    RuntimeError where there is none — pass ``device="cpu"`` to solve on
    the CPU; a BdiaMatrix solves on its own device).  Returns a
    SolveStatus whose ``soln`` is a tensor on that device, in the caller's
    (node-major) ordering.

    ``A``: a HostCSR, a dense 2-D ndarray or a BdiaMatrix.  ``b``: (n,) or
    (n, k); with k columns ``soln`` is (n, k), ``iters`` and ``resid`` the
    largest over the columns, ``reason`` the worst (the block-DIA lane and
    CG and GMRES on a HostCSR solve the columns in lockstep).
    ``method``: "auto" | "cg" | "gmres" | "direct".
    ``precond``: "auto" | "none" | "ic" | "ilut" | "amg" | "jacobi"; on a
    BdiaMatrix "auto" (= "bjacobi") | "none" | "bjacobi" | "bcheb" |
    "bmg" | "ic".
    ``precision``: "native" solves in the matrix dtype; "mixed" runs the
    inner Krylov in f32 on the kernels with f64 refinement, the solution
    in f64.  ``detect_blocks``: on an all-"auto" CG call over a large
    HostCSR (n >= 10,000) with b×b block structure, pack it as a
    BdiaMatrix on ``device`` and take the block-DIA lane; pass False to
    force the scalar route.  ``restart``, ``flexible`` and ``orthog`` go
    to GMRES (CG ignores them); any other keyword is a TypeError.
    """
    if isinstance(A, np.ndarray) and A.ndim == 2:
        A = HostCSR.from_dense(A)
    from .parallel.mesh import check_mesh
    mesh = check_mesh(solver_kwargs.pop("mesh", None))
    unknown = set(solver_kwargs) - set(_GMRES_KWARGS)
    if unknown:
        raise TypeError(f"unexpected arguments {sorted(unknown)}")
    if precision not in ("native", "mixed"):
        raise ValueError(f"precision must be 'native' or 'mixed', "
                         f"got {precision!r}")
    if isinstance(A, BdiaMatrix):
        if mesh is not None:
            return _solve_bdia_mesh(A, b, tau=tau, maxiter=maxiter,
                                    method=method, precond=precond,
                                    precision=precision, mesh=mesh,
                                    **solver_kwargs)
        if device is not None and not same_device(device, A.device):
            raise ValueError(f"the BdiaMatrix is on {A.device}, not on "
                             f"{device}")
        return _solve_bdia(A, b, tau=tau, maxiter=maxiter, method=method,
                           precond=precond, precision=precision,
                           **solver_kwargs)
    if not isinstance(A, HostCSR):
        raise TypeError("solve() takes a HostCSR, a dense ndarray or a "
                        "BdiaMatrix; use the factory API for other device "
                        "formats")
    n = A.shape[0]
    b = np.asarray(b)

    if method == "auto":
        if n <= 500:
            method = "direct"
        else:
            method = "cg" if _is_symmetric(A) else "gmres"

    if mesh is not None:
        return _solve_mesh(A, b, tau=tau, maxiter=maxiter, method=method,
                           precond=precond, precision=precision, mesh=mesh,
                           **solver_kwargs)
    if detect_blocks and method == "cg" and precond == "auto" and n >= 10_000:
        bsz = detect_block_size(A)
        if bsz is not None:
            return _solve_bdia(
                BdiaMatrix.from_host_csr(A, bsz, device=device), b, tau=tau,
                maxiter=maxiter, method="cg", precond="auto",
                precision=precision)
    if b.ndim == 2:
        if b.shape[1] == 0:
            raise ValueError("solve(A, B): B has zero columns")
        return _solve_multi(A, b, tau=tau, maxiter=maxiter, method=method,
                            precond=precond, precision=precision,
                            device=device, **solver_kwargs)
    if b.ndim != 1:
        raise ValueError(f"solve() takes b of shape (n,) or (n, k); got "
                         f"{b.shape}")

    if method == "direct":
        return DefaultDirect(device=device).make_solver().solve(A, b)
    if method not in ("cg", "gmres"):
        raise ValueError(f"unknown method {method!r}")

    prec_type = _precond_type(precond, method, n)
    if precision == "mixed":
        return _cached_mixed_solver(A, method, precond, tau, maxiter,
                                    solver_kwargs.get("restart"), prec_type,
                                    device).solve(A, b)
    control = CommonSolverArgs(maxiter=maxiter, tau=tau)
    if method == "cg":
        factory = PCG(control, precond=prec_type, device=device)
    else:
        factory = GMRES(control, precond=prec_type, device=device,
                        **solver_kwargs)
    return factory.make_solver().solve(A, b)


def _solve_mesh(A: HostCSR, b: np.ndarray, *, tau, maxiter, method,
                precond, precision, mesh, **gmres_kwargs) -> SolveStatus:
    """solve(HostCSR, mesh=): the factories' mesh routes on every rank
    (the direct solve runs whole on each rank's device)."""
    if method == "direct":
        return DefaultDirect(device=mesh.device).make_solver().solve(A, b)
    if method not in ("cg", "gmres"):
        raise ValueError(f"unknown method {method!r}")
    if b.ndim not in (1, 2) or (b.ndim == 2 and b.shape[1] == 0):
        raise ValueError(f"solve() takes b of shape (n,) or (n, k >= 1); "
                         f"got {b.shape}")
    prec_type = _precond_type(precond, method, A.shape[0], mesh=mesh)
    control = CommonSolverArgs(maxiter=maxiter, tau=tau)
    if method == "cg":
        factory = PCG(control, precond=prec_type, precision=precision,
                      mesh=mesh)
    else:
        factory = GMRES(control, precond=prec_type, precision=precision,
                        mesh=mesh, **gmres_kwargs)
    return factory.make_solver().solve(A, b)


def _solve_bdia_mesh(A: BdiaMatrix, b, *, tau, maxiter, method, precond,
                     precision, mesh, **gmres_kwargs) -> SolveStatus:
    """solve(BdiaMatrix, mesh=): the planes sharded on the block-row axis,
    flat planar slabs, K4 on each rank's window per product, the dots
    summed over the ranks (JAX ``solve.py::_solve_bdia_mesh``).
    ``precision="mixed"`` runs ``cg_solve_rr`` with the f64 recurrence on
    the f64 planes and block-Jacobi on the f32 ones."""
    from .parallel.bdia import (block_jacobi_sharded, dist_bdia_spmv,
                                shard_bdia)
    if method in ("auto", "direct"):
        method = "cg"            # BDIA problems are large by construction
    if method not in ("cg", "gmres"):
        raise ValueError(f"unknown method {method!r} for BdiaMatrix")
    if precond not in ("auto", "none", "bjacobi"):
        raise ValueError("mesh= BDIA solves support precond='bjacobi' "
                         "(block-diagonal => rank-local) or 'none'")
    b_np = (b.detach().cpu().numpy() if isinstance(b, torch.Tensor)
            else np.asarray(b))
    if b_np.shape != (A.n_rows,):
        raise ValueError("mesh= BDIA solves take a single RHS")
    control = CommonSolverArgs(maxiter=maxiter, tau=tau)

    def bjacobi(S):
        if precond == "none":
            return None
        apply, state = block_jacobi_sharded(S)
        return lambda v: apply(state, v)

    if precision == "mixed":
        if method != "cg":
            raise ValueError("mesh= mixed BDIA solves run CG (rr); use "
                             "precision='native' for GMRES")
        S32 = shard_bdia(_bdia_cast(A, torch.float32), mesh)
        S64 = shard_bdia(_bdia_cast(A, torch.float64), mesh)
        x, st, _ = cg_solve_rr(
            lambda v: dist_bdia_spmv(S32, v), S64.to_planar(
                b_np.astype(np.float64)),
            mv_hi=lambda v: dist_bdia_spmv(S64, v), maxiter=maxiter,
            tau=tau, precond=bjacobi(S32), hi_matvec=True, psum=mesh.psum)
        return make_status(S64.from_planar(x), st, control, history=None)
    S = shard_bdia(A, mesh)
    krylov = (cg_solve if method == "cg" else
              lambda *a, **k: gmres_solve(*a, **k, **gmres_kwargs))
    x, st, hist = krylov(lambda v: dist_bdia_spmv(S, v),
                         S.to_planar(b_np.astype(numpy_dtype(A.dtype))),
                         maxiter=maxiter, tau=tau, precond=bjacobi(S),
                         norm_fn=mesh.norm_fn(), psum=mesh.psum)
    return make_status(S.from_planar(x), st, control, history=hist)


_BDIA_PRECONDS = ("auto", "none", "bjacobi", "bcheb", "bmg", "ic")
_BDIA_PRECOND_TYPES = {"bjacobi": BlockJacobiBdiaPreconditionerType,
                       "bcheb": BlockChebyshevBdiaPreconditionerType,
                       "bmg": BlockMGBdiaPreconditionerType}

# Repeat-solve cache for BdiaMatrix operators: formed preconditioners (and
# the block-Jacobi inverse as a BdiaMatrix) keyed on the planes tensor's
# identity.  The entry holds a strong reference, so an id is never reused
# while it lives, and records the tensor's version counter, so an in-place
# update of the planes forms anew.  Without it every solve() re-pays the
# setup — for "bmg" b SA hierarchy builds.
_BDIA_SOLVE_CACHE: dict = {}


def _bdia_cached(A: BdiaMatrix, key, make):
    """``make()`` for this planes tensor, formed once and kept in its cache
    entry under ``key``."""
    ent = _BDIA_SOLVE_CACHE.get(id(A.planes))
    if (ent is None or ent["planes"] is not A.planes
            or ent["version"] != A.planes._version):
        _BDIA_SOLVE_CACHE.pop(id(A.planes), None)
        ent = fifo_put(_BDIA_SOLVE_CACHE, id(A.planes),
                       {"planes": A.planes, "version": A.planes._version}, 8)
    if key not in ent:
        ent[key] = make()
    return ent[key]


def _bdia_ic_form(A: BdiaMatrix) -> Preconditioner:
    """Scalar IC(t) of A's node-major host CSR view, factored in f32 as in
    the JAX package (``solve.py:242-255``), applied to a planar vector
    through node-major reorders in A's dtype: the level solves promote, and
    the block plans ("auto" on the card) are built in it from the f32
    factor.  (The JAX package's f32 block plans make the apply inexact,
    which non-flexible GMRES reports as a true-residual mismatch.)"""
    H = A.to_host_csr()
    H32 = HostCSR(H.indptr, H.indices, H.data.astype(np.float32), H.shape)
    inner = ICPreconditionerType().form(H32, device=A.device,
                                        apply_dtype=numpy_dtype(A.dtype))

    def apply(v):
        return A.to_planar(inner.apply_any(A.from_planar(v)).to(v.dtype))

    return Preconditioner(right=apply)


def _bdia_precond(A: BdiaMatrix, precond: str):
    """The planar preconditioner apply for a BdiaMatrix (None for "none");
    the Preconditioner is formed once per planes tensor and kept in the
    cache entry under ("prec", name)."""
    if precond == "auto":
        precond = "bjacobi"
    if precond == "none":
        return None
    form = ((lambda: _bdia_ic_form(A)) if precond == "ic" else
            (lambda: _BDIA_PRECOND_TYPES[precond]().form(A_dev=A)))
    return _bdia_cached(A, ("prec", precond), form).apply_any


def _bdia_cast(A: BdiaMatrix, dtype) -> BdiaMatrix:
    """A in ``dtype`` (itself when it is already), kept in A's cache
    entry."""
    if A.dtype == dtype:
        return A
    return _bdia_cached(A, ("cast", str(dtype)), lambda: A.astype(dtype))


def _solve_bdia(A: BdiaMatrix, b, *, tau, maxiter, method,
                precond="auto", precision="native",
                **gmres_kwargs) -> SolveStatus:
    """solve() route for a BdiaMatrix: node-major b in, node-major solution
    out; the Krylov loop runs in the format's planar ordering in between,
    on the matrix's device (GMRES: single right-hand side, K4 for the
    operator, ``gmres_kwargs`` forwarded).  ``precision="mixed"``: the
    refinement of ``_solve_bdia_mixed`` / ``_solve_bdia_multi_mixed``."""
    if method in ("auto", "direct"):
        method = "cg"            # BDIA problems are large by construction
    if method not in ("cg", "gmres"):
        raise ValueError(f"unknown method {method!r} for BdiaMatrix")
    if precond not in _BDIA_PRECONDS:
        raise ValueError(f"unknown BDIA precond {precond!r}; expected one "
                         f"of {_BDIA_PRECONDS}")
    control = CommonSolverArgs(maxiter=maxiter, tau=tau)
    if precision == "mixed":
        b_np = (b.detach().cpu().numpy() if isinstance(b, torch.Tensor)
                else np.asarray(b)).astype(np.float64)
        if b_np.ndim == 2 and b_np.shape[0] == A.n_rows and b_np.shape[1]:
            return _solve_bdia_multi_mixed(A, b_np, tau=tau, maxiter=maxiter,
                                           precond=precond)
        if b_np.shape != (A.n_rows,):
            raise ValueError(f"solve(BdiaMatrix) takes b of shape "
                             f"({A.n_rows},) or ({A.n_rows}, k >= 1); got "
                             f"{b_np.shape}")
        return _solve_bdia_mixed(A, b_np, tau=tau, maxiter=maxiter,
                                 method=method, precond=precond,
                                 control=control,
                                 restart=gmres_kwargs.get("restart"))
    bd = torch.as_tensor(b, dtype=A.dtype, device=A.device)
    if bd.ndim == 1 and bd.shape[0] == A.n_rows:
        papply = _bdia_precond(A, precond)
        krylov = (cg_solve if method == "cg" else
                  lambda *a, **k: gmres_solve(*a, **k, **gmres_kwargs))
        x, st, hist = krylov(lambda v: bdia_spmv(A, v), A.to_planar(bd),
                             maxiter=maxiter, tau=tau, precond=papply)
        return make_status(A.from_planar(x), st, control, history=hist)
    if bd.ndim != 2 or bd.shape[0] != A.n_rows or bd.shape[1] == 0:
        raise ValueError(f"solve(BdiaMatrix) takes b of shape ({A.n_rows},) "
                         f"or ({A.n_rows}, k >= 1); got {tuple(bd.shape)}")
    if method == "gmres":
        # the JAX block lane runs CG here whatever the method says
        raise ValueError("solve(BdiaMatrix, B) with several right-hand sides "
                         "runs lockstep CG only: pass method=\"cg\" (the "
                         "JAX package runs CG for method=\"gmres\" there)")

    # lockstep multi-RHS in ROW layout (k, b·nb): one planar RHS per row,
    # K5 for the operator
    k = bd.shape[1]
    B_rows = A.to_planar(bd).T.contiguous()
    if precond in ("auto", "bjacobi"):
        # block-Jacobi as a D = 1 BdiaMatrix: applied through K5 too
        M = _bdia_cached(A, "bjacobi_matrix",
                         lambda: block_jacobi_bdia_matrix(A))
        pmulti = lambda V: bdia_spmm_rows(M, V)          # noqa: E731
    else:
        papply = _bdia_precond(A, precond)
        # the single-RHS apply row by row (JAX vmaps it)
        pmulti = None if papply is None else per_vector(papply, dim=0)
    X, st, _ = cg_solve_multi_rows(lambda V: bdia_spmm_rows(A, V), B_rows,
                                   maxiter=maxiter, tau=tau, precond=pmulti)
    # (k, b·nb) planar rows -> node-major (n, k)
    Xn = X.reshape(k, A.b, A.nb).permute(2, 1, 0).reshape(A.nb * A.b, k)
    return _block_status(Xn, st, tau, maxiter)


def _solve_bdia_mixed(A: BdiaMatrix, b_np: np.ndarray, *, tau, maxiter,
                      method, precond, control, restart) -> SolveStatus:
    """One right-hand side on a BdiaMatrix at mixed precision:
    ``ir_solve_dd`` with K4 in f32 for the inner solve, K4 in f64 on the
    f64 planes as the oracle and the host product of the f64 planes as the
    check; the preconditioner is formed on the f32 planes.  Block-Jacobi
    and Chebyshev (and none) are weak and symmetric: the f32 recurrence and
    a 48-step replacement cadence (an f64 product per step would cost
    more than the iterations it saves); "bmg" is strong but its
    iterations are cheap, so it keeps the f32 recurrence too; IC takes the
    strong-preconditioner defaults."""
    A32 = _bdia_cast(A, torch.float32)
    A64 = _bdia_cast(A, torch.float64)
    papply = _bdia_precond(A32, precond)
    bp = b_np.reshape(A.nb, A.b).T.reshape(-1)         # planar, on the host
    weak = precond in ("auto", "bjacobi", "bcheb", "none")
    x, st, _ = ir_solve_dd(
        A64.host_matvec_planar, bp, A_lo=A32, A64=A64, tau=tau,
        inner_tau=max(min(tau, 0.5), 1e-6), inner_maxiter=maxiter,
        method=method, restart=restart, precond_lo=papply,
        hi_matvec=False if (weak or precond == "bmg") else None,
        replace_every=48 if weak else None)
    return make_status(A.from_planar(x), st, control, history=None)


def _solve_bdia_multi_mixed(A: BdiaMatrix, B_np: np.ndarray, *, tau,
                            maxiter, precond) -> SolveStatus:
    """k right-hand sides on a BdiaMatrix at mixed precision, in the row
    layout (k, b·nb).  Block-Jacobi (and none): one continuous
    ``cg_lockstep_rr`` pass, K5 in f32 for the operator and for
    block-Jacobi (a D = 1 BdiaMatrix of the f32 planes), K5 in f64 for the
    replacements, every 48 steps.  The other preconditioners:
    ``ir_solve_multi`` around lockstep CG with the single-RHS apply row by
    row.  Per right-hand side CG semantics; ``soln`` is (n, k) in f64."""
    k = B_np.shape[1]
    A32 = _bdia_cast(A, torch.float32)
    A64 = _bdia_cast(A, torch.float64)
    B_rows = torch.as_tensor(np.ascontiguousarray(
        B_np.T.reshape(k, A.nb, A.b).transpose(0, 2, 1).reshape(
            k, A.b * A.nb)), device=A.device)
    if precond in ("auto", "none", "bjacobi"):
        pmulti = None
        if precond != "none":
            M = _bdia_cached(A32, "bjacobi_matrix",
                             lambda: block_jacobi_bdia_matrix(A32))
            pmulti = lambda V: bdia_spmm_rows(M, V)      # noqa: E731
        X, st, _ = cg_lockstep_rr(
            lambda V: bdia_spmm_rows(A32, V), B_rows,
            mm_hi=lambda V: bdia_spmm_rows(A64, V), maxiter=maxiter,
            tau=tau, precond=pmulti, replace_every=48)
    else:
        papply = _bdia_precond(A32, precond)
        pmulti = per_vector(papply, dim=0)

        def inner_solve(R32, tau32):
            D, st, _ = cg_solve_multi_rows(
                lambda V: bdia_spmm_rows(A32, V), R32, maxiter=maxiter,
                tau=tau32, precond=pmulti)
            return D, st.k

        X, st, _ = ir_solve_multi(
            lambda V: bdia_spmm_rows(A64, V), B_rows,
            inner_solve=inner_solve,
            col_norm=lambda V: torch.sqrt(torch.sum(V * V, dim=1)),
            bc=lambda s: s[:, None], tau=tau,
            inner_tau=max(min(tau, 0.5), 1e-6))
    # (k, b·nb) planar rows -> node-major (n, k)
    Xn = X.reshape(k, A.b, A.nb).permute(2, 1, 0).reshape(A.nb * A.b, k)
    return _block_status(Xn, st, tau, maxiter)


def _block_status(X, st, tau, maxiter) -> SolveStatus:
    """One SolveStatus of a lockstep solve: the largest iterations and
    residual over the columns, the worst reason (RUNNING < CONVERGED <
    the failures)."""
    agg = KrylovState(int(st.k.max()), st.resid.max(), int(st.reason.max()))
    return make_status(X, agg, CommonSolverArgs(maxiter=maxiter, tau=tau))


def _solve_multi(A: HostCSR, B: np.ndarray, *, tau, maxiter, method,
                 precond, precision, device, **solver_kwargs) -> SolveStatus:
    """k right-hand sides on a HostCSR (JAX ``solve.py::_solve_multi``):
    lockstep CG or GMRES, at native precision in the matrix's dtype, at
    mixed precision ``_solve_multi_mixed``; the direct solve, and GMRES
    with ``orthog``/``flexible`` or a basis above 2³¹ bytes, by the column
    loop.  ``soln`` is (n, k) on ``device``."""
    if method in ("cg", "gmres") and precision == "mixed":
        return _solve_multi_mixed(A, B, tau=tau, maxiter=maxiter,
                                  method=method, precond=precond,
                                  device=device,
                                  restart=solver_kwargs.get("restart"))
    if method not in ("cg", "gmres"):
        return _solve_multi_column_loop(A, B, tau=tau, maxiter=maxiter,
                                        method=method, precond=precond,
                                        device=device, **solver_kwargs)
    n, k = B.shape
    restart = solver_kwargs.get("restart")
    if method == "gmres":
        # gmres_solve_multi runs MGS without a flexible basis, and holds
        # the whole (m+1, n, k) basis: other requests take the column loop
        mlen = maxiter if restart is None else max(1, min(int(restart),
                                                          maxiter))
        basis_bytes = (mlen + 1) * n * k * np.dtype(A.data.dtype).itemsize
        if ("orthog" in solver_kwargs or "flexible" in solver_kwargs
                or basis_bytes > (1 << 31)):
            return _solve_multi_column_loop(A, B, tau=tau, maxiter=maxiter,
                                            method=method, precond=precond,
                                            device=device, **solver_kwargs)
    A_host, A_dev = as_device_matrix(A, device=device)
    prec_type = _precond_type(precond, method, n)
    pmulti = None
    if prec_type is not None:
        prec = prec_type.form(A_host, A_dev, device=A_dev.device)
        if not prec.is_identity:
            pmulti = per_vector(prec.apply_any)
    # in the MATRIX dtype, as the single-RHS route solves
    Bd = torch.as_tensor(B, dtype=A_dev.dtype, device=A_dev.device)
    mm = lambda V: matmat(A_dev, V)                       # noqa: E731
    if method == "cg":
        X, st, _ = cg_solve_multi(mm, Bd, maxiter=maxiter, tau=tau,
                                  precond=pmulti)
    else:
        X, st, _ = gmres_solve_multi(mm, Bd, maxiter=maxiter, tau=tau,
                                     precond=pmulti, restart=restart)
    return _block_status(X, st, tau, maxiter)


def _solve_multi_mixed(A: HostCSR, B: np.ndarray, *, tau, maxiter, method,
                       precond, device, restart) -> SolveStatus:
    """k right-hand sides at mixed precision (JAX
    ``solve.py::_solve_multi_mixed``) on the factories' operators
    (``api.mixed_operators``): CG as ONE continuous ``cg_lockstep_rr`` pass
    in column layout (f32 operator and preconditioner, the f64 oracle for
    the per-column replacements every 48 steps); GMRES as
    ``ir_solve_multi`` with ``gmres_solve_multi`` in f32 inside.  The
    preconditioner is formed on the f32 host matrix.  A BWS pack's RCM
    ordering is taken on B's rows and undone on X's.  ``soln`` is (n, k) in
    f64."""
    dev = resolve_device(device)
    mx = mixed_operators(A, None, dev)
    A32, A64 = mx["A32"], mx["A64"]
    prec_type = _precond_type(precond, method, A.shape[0])
    pmulti = None
    if prec_type is not None:
        prec = prec_type.form(mx["Hp32"], A32, device=dev)
        if not prec.is_identity:
            pmulti = per_vector(prec.apply_any)
    B64 = np.asarray(B, dtype=np.float64)
    if mx["perm"] is not None:
        B64 = B64[mx["perm"]]
    B64 = torch.as_tensor(np.ascontiguousarray(B64), device=dev)
    if method == "cg":
        X, st, _ = cg_lockstep_rr(
            lambda V: matmat(A32, V), B64, mm_hi=lambda V: matmat(A64, V),
            maxiter=maxiter, tau=tau, precond=pmulti, replace_every=48,
            dot=lambda a, c: torch.sum(a * c, dim=0),
            bc=lambda s: s[None, :], n_rhs=B64.shape[1])
    else:
        def inner_solve(R32, tau32):
            D, st, _ = gmres_solve_multi(lambda V: matmat(A32, V), R32,
                                         maxiter=maxiter, tau=tau32,
                                         precond=pmulti, restart=restart)
            return D, st.k

        X, st, _ = ir_solve_multi(
            lambda V: matmat(A64, V), B64, inner_solve=inner_solve,
            col_norm=lambda V: torch.sqrt(torch.sum(V * V, dim=0)),
            bc=lambda s: s[None, :], tau=tau,
            inner_tau=max(min(tau, 0.5), 1e-6))
    if mx["iperm"] is not None:
        X = X[mx["iperm"]]
    return _block_status(X, st, tau, maxiter)


def _solve_multi_column_loop(A: HostCSR, B: np.ndarray, *, tau, maxiter,
                             method, precond, device,
                             **solver_kwargs) -> SolveStatus:
    """The columns one by one through ONE solver, so the setup
    (factorization, packs) is paid once: the direct solve, or a native
    CG/GMRES factory with the matrix and the preconditioner frozen.
    ``soln`` stacks the columns' solutions (n, k); ``iters`` and ``resid``
    are the largest, ``reason`` the first failure's."""
    if method == "direct":
        s = DefaultDirect(device=device).make_solver()
    elif method in ("cg", "gmres"):
        control = CommonSolverArgs(maxiter=maxiter, tau=tau)
        prec_type = _precond_type(precond, method, A.shape[0])
        factory = (PCG(control, precond=prec_type, device=device)
                   if method == "cg" else
                   GMRES(control, precond=prec_type, device=device,
                         **solver_kwargs))
        s = factory.make_solver()
        s.freeze_matrix()
        s.freeze_prec()
    else:
        raise ValueError(f"unknown method {method!r}")
    sts = [s.solve(A, B[:, j]) for j in range(B.shape[1])]
    failed = [st for st in sts if not st.success]
    return SolveStatus(
        success=not failed,
        soln=(None if any(st.soln is None for st in sts) else
              torch.stack([torch.as_tensor(st.soln) for st in sts], dim=1)),
        resid=max(float(st.resid) for st in sts),
        iters=max(int(st.iters) for st in sts),
        reason=failed[0].reason if failed else StopReason.CONVERGED,
        msg="; ".join(sorted({st.msg for st in sts if st.msg})))


# --- mixed-precision solver cache ------------------------------------------
# The factories' mixed route keeps its packed operators on the solver while
# the matrix is frozen; this cache keeps solvers across solve() calls.  The
# key carries a fingerprint of the values, so a re-solve after an in-place
# update of A.data forms anew instead of serving the old operator.
_MIXED_CACHE: dict = {}


def _cached_mixed_solver(A: HostCSR, method: str, precond: str, tau: float,
                         maxiter: int, restart, prec_type, device):
    key = (id(A), hash(A.data.tobytes()), method, precond, tau, maxiter,
           restart, str(device))
    ent = _MIXED_CACHE.get(key)
    if ent is not None and ent[0] is A:
        return ent[1]
    control = CommonSolverArgs(maxiter=maxiter, tau=tau)
    if method == "cg":
        factory = PCG(control, precond=prec_type, precision="mixed",
                      device=device)
    else:
        factory = GMRES(control, precond=prec_type, precision="mixed",
                        restart=restart, device=device)
    s = factory.make_solver()
    s.freeze_matrix()
    fifo_put(_MIXED_CACHE, key, (A, s), 8)
    return s
