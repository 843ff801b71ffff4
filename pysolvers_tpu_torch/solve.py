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

The others raise ``NotImplementedError`` naming their ROADMAP slice:
multi-RHS on a HostCSR that is not block-structured and GMRES with
several right-hand sides at native precision (slice 10) and ``mesh=``
(slice 12).  None of them falls through to another route.
"""
from __future__ import annotations

import numpy as np
import torch

from .api import CommonSolverArgs, DefaultDirect, GMRES, PCG
from .core import SolveStatus, make_status
from .linear.amg import AMGPreconditionerType
from .linear.block_precond import (BlockChebyshevBdiaPreconditionerType,
                                   BlockJacobiBdiaPreconditionerType,
                                   BlockMGBdiaPreconditionerType,
                                   block_jacobi_bdia_matrix)
from .linear.ilu import ICPreconditionerType, ILUTPreconditionerType
from .linear.krylov import (KrylovState, cg_lockstep_rr, cg_solve,
                            cg_solve_multi_rows, gmres_solve)
from .linear.refine import ir_solve_dd, ir_solve_multi
from .linear.preconditioner import JacobiPreconditionerType, Preconditioner
from .ops.spmv import bdia_spmm_rows, bdia_spmv
from .sparse.bdia import BdiaMatrix, detect_block_size
from .sparse.device import numpy_dtype, same_device
from .sparse.host import HostCSR


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


def _precond_type(precond: str, method: str, n: int):
    """Resolve a precond name to a PreconditionerType (or None).  Unknown
    names raise — a typo must not silently run unpreconditioned."""
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

    ``A``: a HostCSR, a dense 2-D ndarray or a BdiaMatrix.  ``b``: (n,);
    (n, k) on the block-DIA lane, which solves the k columns in lockstep
    (``soln`` is then (n, k), ``iters`` and ``resid`` the largest over the
    columns, ``reason`` the worst).
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
    if "mesh" in solver_kwargs:
        raise NotImplementedError("mesh= is not ported yet (ROADMAP slice 12)")
    unknown = set(solver_kwargs) - set(_GMRES_KWARGS)
    if unknown:
        raise TypeError(f"unexpected arguments {sorted(unknown)}")
    if precision not in ("native", "mixed"):
        raise ValueError(f"precision must be 'native' or 'mixed', "
                         f"got {precision!r}")
    if isinstance(A, BdiaMatrix):
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

    if detect_blocks and method == "cg" and precond == "auto" and n >= 10_000:
        bsz = detect_block_size(A)
        if bsz is not None:
            return _solve_bdia(
                BdiaMatrix.from_host_csr(A, bsz, device=device), b, tau=tau,
                maxiter=maxiter, method="cg", precond="auto",
                precision=precision)
    if b.ndim == 2:
        raise NotImplementedError("multi-RHS solves of a HostCSR that is not "
                                  "block-structured are not ported yet "
                                  "(ROADMAP slice 10)")
    if b.ndim != 1:
        raise ValueError(f"solve() takes b of shape (n,); got {b.shape}")

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
        if len(_BDIA_SOLVE_CACHE) >= 8:
            _BDIA_SOLVE_CACHE.pop(next(iter(_BDIA_SOLVE_CACHE)))
        ent = {"planes": A.planes, "version": A.planes._version}
        _BDIA_SOLVE_CACHE[id(A.planes)] = ent
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
                                           precond=precond, control=control)
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
        raise NotImplementedError("GMRES with several right-hand sides is "
                                  "not ported yet (ROADMAP slice 10, "
                                  "gmres_solve_multi)")

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
        # the single-RHS apply row by row (JAX vmaps it; the kernels'
        # launches cannot be batched that way)
        pmulti = (None if papply is None else
                  lambda V: torch.stack([papply(v) for v in V]))
    X, st, hist = cg_solve_multi_rows(lambda V: bdia_spmm_rows(A, V), B_rows,
                                      maxiter=maxiter, tau=tau,
                                      precond=pmulti)
    agg = KrylovState(int(st.k.max()), st.resid.max(), int(st.reason.max()))
    # (k, b·nb) planar rows -> node-major (n, k)
    Xn = X.reshape(k, A.b, A.nb).permute(2, 1, 0).reshape(A.nb * A.b, k)
    return make_status(Xn, agg, control, history=hist)


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
                            maxiter, precond, control) -> SolveStatus:
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
        pmulti = lambda V: torch.stack([papply(v) for v in V])  # noqa: E731

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
    agg = KrylovState(int(st.k.max()), st.resid.max(), int(st.reason.max()))
    # (k, b·nb) planar rows -> node-major (n, k)
    Xn = X.reshape(k, A.b, A.nb).permute(2, 1, 0).reshape(A.nb * A.b, k)
    return make_status(Xn, agg, control)


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
    if len(_MIXED_CACHE) >= 8:
        _MIXED_CACHE.pop(next(iter(_MIXED_CACHE)))
    _MIXED_CACHE[key] = (A, s)
    return s
