"""The port's CG against the JAX package's ``cg_solve`` on the same seeded
inputs (f64): same stop reason, iterations within ±1, and solutions within
1e-6 relative at tau = 1e-10 (the two loops round dot products in
different orders, so the iterates drift apart by ~1e-16 per step and the
solution error of either is ~tau·cond)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysolvers_tpu as pst
import pysolvers_tpu_torch as pt
from pysolvers_tpu.linear.krylov import cg_solve as jax_cg
from pysolvers_tpu_torch.core import StopReason
from pysolvers_tpu_torch.linear.krylov import cg_solve

torch.set_num_threads(1)


def _problem(m=32, seed=0):
    Hj = pst.problems.fd_laplacian_2d(m)
    Ht = pt.problems.fd_laplacian_2d(m)
    b = Hj.matvec(np.random.default_rng(seed).random(Hj.shape[0]))
    return Hj, Ht, b


def _run_both(b, maxiter, tau, precond="jacobi", m=32):
    Hj, Ht, _ = _problem(m)
    Aj = pst.DiaMatrix.from_host_csr(Hj)
    At = pt.DiaMatrix.from_host_csr(Ht, device="cpu")
    pj = (pst.JacobiPreconditionerType().form(Hj).apply_any
          if precond == "jacobi" else None)
    pp = (pt.JacobiPreconditionerType().form(Ht, device="cpu").apply_any
          if precond == "jacobi" else None)
    xj, sj, hj = jax_cg(lambda v: pst.matvec(Aj, v), jnp.asarray(b),
                        maxiter=maxiter, tau=tau, precond=pj)
    xt, stt, ht = cg_solve(lambda v: pt.matvec(At, v), torch.from_numpy(b),
                           maxiter=maxiter, tau=tau, precond=pp)
    return (np.asarray(xj), sj, np.asarray(hj)), (xt.numpy(), stt, ht.numpy())


@pytest.mark.parametrize("precond", ["jacobi", "none"])
def test_cg_matches_jax(precond):
    _, _, b = _problem()
    (xj, sj, hj), (xt, st, ht) = _run_both(b, 500, 1e-10, precond)
    assert int(sj.reason) == st.reason == StopReason.CONVERGED
    assert abs(int(sj.k) - st.k) <= 1
    assert np.linalg.norm(xt - xj) / np.linalg.norm(xj) <= 1e-6
    k = min(int(sj.k), st.k)
    np.testing.assert_allclose(ht[: k + 1], hj[: k + 1], rtol=1e-6)
    assert np.isnan(ht[st.k + 1:]).all()


def test_trivial_b():
    b = np.zeros(32 * 32)
    (xj, sj, _), (xt, st, _) = _run_both(b, 50, 1e-10)
    assert int(sj.reason) == st.reason == StopReason.CONVERGED
    assert int(sj.k) == st.k == 0
    assert not xt.any() and not xj.any()


@pytest.mark.parametrize("maxiter", [0, 1, 5])
def test_maxiter(maxiter):
    _, _, b = _problem()
    (xj, sj, _), (xt, st, _) = _run_both(b, maxiter, 1e-14)
    assert int(sj.reason) == st.reason == StopReason.MAXITER
    assert int(sj.k) == st.k == max(maxiter, 1)
    np.testing.assert_allclose(xt, xj, rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("fail_on_maxiter", [True, False])
def test_pcg_factory_maxiter_rule(fail_on_maxiter):
    """PCGSolver + make_status: maxiter counts as success only when
    fail_on_maxiter is off (reference IterativeSolver.py:117-129)."""
    Hj, Ht, b = _problem()
    st = pt.PCG(pt.CommonSolverArgs(maxiter=3, tau=1e-14,
                                    failOnMaxiter=fail_on_maxiter),
                precond=pt.JacobiPreconditionerType(),
                device="cpu").make_solver().solve(Ht, b)
    sj = pst.PCG(pst.CommonSolverArgs(maxiter=3, tau=1e-14,
                                      failOnMaxiter=fail_on_maxiter),
                 precond=pst.JacobiPreconditionerType()
                 ).make_solver().solve(Hj, b)
    assert st.reason == sj.reason == StopReason.MAXITER
    assert st.success == sj.success == (not fail_on_maxiter)
    assert st.iters == sj.iters == 3
    assert st.soln.device.type == "cpu"


def test_pcg_factory_matches_jax_and_tolerance_override():
    Hj, Ht, b = _problem()
    solver = pt.PCG(pt.CommonSolverArgs(maxiter=500, tau=1e-4),
                    precond=pt.JacobiPreconditionerType(),
                    device="cpu").make_solver()
    solver.set_tolerance(1e-10)
    st = solver.solve(Ht, b)
    sj = pst.PCG(pst.CommonSolverArgs(maxiter=500, tau=1e-10),
                 precond=pst.JacobiPreconditionerType()
                 ).make_solver().solve(Hj, b)
    assert st.success and st.reason == sj.reason
    assert abs(st.iters - sj.iters) <= 1
    xj = np.asarray(sj.soln)
    assert np.linalg.norm(st.soln.numpy() - xj) / np.linalg.norm(xj) <= 1e-6
