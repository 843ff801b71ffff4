"""``PCG``/``GMRES(precision="mixed")`` of the port against the JAX
package's on the same seeded inputs, tau = 1e-10:

* the DIA route (fd_laplacian_2d(31), f32 DIA inner, f64 DIA oracle) and
  the CPU's ELL route (fem_poisson_2d_unstructured(17, seed=3), n = 289),
  Jacobi or no preconditioner formed on the f32 host matrix;
* the BWS route on the CPU (the port's ``api._bws_route`` and the JAX
  package's ``_bws_backend`` both patched true; JAX runs its BWS kernel in
  interpret mode, the port K2's twin): the RCM-ordered f32 pack, an f64
  pack of the permuted matrix as the oracle, AMG on the permuted f32 host
  matrix, the solution back in the caller's order;
* a DIA device matrix without its host matrix (host residuals from its
  diagonals, ``ir_solve_host``);
Gates: the same stop reason, iterations within ±1, the f64 solutions
within 1e-8 relative.  Also: frozen re-solves reuse the packed operators,
``norm="inf"`` raises ValueError, and the host reads of the inner
``cg_solve_rr`` are one per iteration plus one per replacement.
"""
import numpy as np
import pytest
import torch

import pysolvers_tpu as pst
import pysolvers_tpu.api as japi
from pysolvers_tpu.linear.preconditioner import (
    JacobiPreconditionerType as JaxJacobi)
from pysolvers_tpu.problems import fem as jfem
import pysolvers_tpu_torch as pt
import pysolvers_tpu_torch.api as tapi
from pysolvers_tpu_torch.core import StopReason
from pysolvers_tpu_torch.linear import krylov as tk
from pysolvers_tpu_torch.ops import spmv

torch.set_num_threads(1)
ARGS = dict(maxiter=500, tau=1e-10)


def _rel(x, y):
    x, y = np.asarray(x), np.asarray(y)
    return float(np.linalg.norm(x - y) / np.linalg.norm(y))


def _agree(st, sj, tol=1e-8):
    assert st.reason == sj.reason == StopReason.CONVERGED
    assert abs(st.iters - sj.iters) <= 1
    assert st.soln.dtype == torch.float64 and st.soln.device.type == "cpu"
    assert _rel(st.soln.numpy(), sj.soln) <= tol


def _systems(kind):
    if kind == "dia":
        Hj, Ht = (pst.problems.fd_laplacian_2d(31),
                  pt.problems.fd_laplacian_2d(31))
        seed = 2
    else:
        Hj = jfem.fem_poisson_2d_unstructured(17, seed=3)
        Ht = pt.problems.fem_poisson_2d_unstructured(17, seed=3)
        seed = 7
    return Hj, Ht, Hj.matvec(np.random.default_rng(seed).random(Hj.shape[0]))


@pytest.mark.parametrize("kind", ["dia", "ell"])
@pytest.mark.parametrize("method", ["PCG", "GMRES"])
def test_factory_mixed_matches_jax(kind, method):
    Hj, Ht, b = _systems(kind)
    jac = method == "PCG" or kind == "dia"
    sj = getattr(pst, method)(
        pst.CommonSolverArgs(**ARGS), precond=JaxJacobi() if jac else None,
        precision="mixed").make_solver().solve(Hj, b)
    s = getattr(pt, method)(
        pt.CommonSolverArgs(**ARGS),
        precond=pt.JacobiPreconditionerType() if jac else None,
        precision="mixed", device="cpu").make_solver()
    st = s.solve(Ht, b)
    _agree(st, sj)
    A32, A64 = s._mx["A32"], s._mx["A64"]
    fmt = pt.DiaMatrix if kind == "dia" else pt.EllMatrix
    assert isinstance(A32, fmt) and isinstance(A64, fmt)
    assert A32.dtype == torch.float32 and A64.dtype == torch.float64


def test_bws_route_matches_jax(monkeypatch):
    monkeypatch.setattr(japi, "_bws_backend", lambda: True)
    monkeypatch.setattr(tapi, "_bws_route", lambda device: True)
    Hj, Ht, b = _systems("ell")
    sj = pst.PCG(pst.CommonSolverArgs(**ARGS),
                 precond=pst.AMG(num_iters=2, num_levels=2),
                 precision="mixed").make_solver().solve(Hj, b)
    s = pt.PCG(pt.CommonSolverArgs(**ARGS),
               precond=pt.AMG(num_iters=2, num_levels=2,
                              matrix_format="bws"),
               precision="mixed", device="cpu").make_solver()
    before = spmv.dia_spmv_launches
    st = s.solve(Ht, b)
    _agree(st, sj)
    A32, A64, perm = s._mx["A32"], s._mx["A64"], s._mx["perm"]
    assert isinstance(A32, pt.BwsMatrix) and isinstance(A64, pt.BwsMatrix)
    assert A32.dtype == torch.float32 and A64.dtype == torch.float64
    # the oracle applies the permuted matrix in the f32 pack's order, made
    # from the f64 host data (not cast up from the f32 pack)
    v = np.random.default_rng(0).random(Ht.shape[0])
    Hp = Ht.permute_symmetric(perm)
    np.testing.assert_allclose(pt.matvec(A64, torch.as_tensor(v)).numpy(),
                               Hp.matvec(v), rtol=1e-13, atol=1e-12)
    assert np.array_equal(perm, A32.perm.numpy())
    # the AMG fine level is the caller's f32 pack itself
    assert s._formed_prec.state.levels[-1].A_dev is A32
    assert spmv.dia_spmv_launches == before


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dia_device_matrix_alone_matches_jax(dtype):
    """An f32 DIA device matrix alone refines with host residuals from its
    diagonals (``ir_solve_host``); an f64 one is its own oracle
    (``ir_solve_dd``)."""
    Hj, Ht, b = _systems("dia")
    sj = pst.PCG(pst.CommonSolverArgs(**ARGS), precision="mixed") \
        .make_solver().solve(pst.DiaMatrix.from_host_csr(Hj, dtype=dtype), b)
    A = pt.DiaMatrix.from_host_csr(Ht, dtype=dtype, device="cpu")
    s = pt.PCG(pt.CommonSolverArgs(**ARGS), precision="mixed",
               device="cpu").make_solver()
    st = s.solve(A, b)
    _agree(st, sj)
    assert (s._mx["A64"] is A) == (dtype == np.float64)


def test_frozen_resolve_reuses_the_operators():
    _, Ht, b = _systems("dia")
    s = pt.PCG(pt.CommonSolverArgs(**ARGS),
               precond=pt.JacobiPreconditionerType(), precision="mixed",
               device="cpu").make_solver()
    s.freeze_matrix()
    s.freeze_prec()
    st1 = s.solve(Ht, b)
    mx, prec = s._mx, s._formed_prec
    st2 = s.solve(Ht, 2.0 * b)
    assert s._mx is mx and s._formed_prec is prec
    assert st2.iters == st1.iters
    np.testing.assert_allclose(st2.soln.numpy(), 2.0 * st1.soln.numpy(),
                               rtol=1e-9)
    s.unfreeze_matrix()
    s.solve(Ht, b)
    assert s._mx is not mx


def test_bad_arguments_raise():
    _, Ht, b = _systems("dia")
    for factory in (pt.PCG, pt.GMRES):
        s = factory(pt.CommonSolverArgs(norm="inf", **ARGS),
                    precision="mixed", device="cpu").make_solver()
        with pytest.raises(ValueError, match="2-norm"):
            s.solve(Ht, b)
    with pytest.raises(ValueError, match="precision"):
        pt.PCG(precision="half", device="cpu")
    with pytest.raises(ValueError, match="HostCSR"):
        pt.PCG(precision="mixed", device="cpu").make_solver().solve(
            torch.eye(4, dtype=torch.float64), np.ones(4))


def test_host_reads_of_the_inner_solve(monkeypatch):
    """PCG at mixed precision, no preconditioner (the f32 recurrence): the
    inner ``cg_solve_rr`` reads the host once per iteration, once more per
    replacement (each is one f64 product of the oracle) and once at the
    start; unpreconditioned, it replaces every 48 steps or on the drop
    and claim triggers.  The pass itself adds an f64 product before and
    after."""
    _, Ht, b = _systems("dia")
    reads, f64 = [], []
    monkeypatch.setattr(tk, "_host",
                        lambda t: reads.append(1) or t.cpu().numpy())
    k1 = spmv.dia_spmv
    monkeypatch.setattr(spmv, "dia_spmv", lambda A, x: (
        f64.append(1) if A.dtype == torch.float64 else None) or k1(A, x))
    st = pt.PCG(pt.CommonSolverArgs(**ARGS), precision="mixed",
                device="cpu").make_solver().solve(Ht, b)
    assert st.reason == StopReason.CONVERGED and st.iters > 50
    replacements = len(f64) - 2
    assert st.iters // 48 <= replacements <= st.iters // 2
    assert len(reads) == 1 + st.iters + replacements
