"""Newton (slice 9) of the port against the JAX package on the same inputs
(f64, Bratu m <= 31): the same number of Newton steps and the same stop
reason; solutions within 1e-10 relative at native precision and 1e-8 at
mixed (the inner solves round their dots in other orders, so the
iterates differ by rounding); the Bratu Jacobians bit-equal (the bump
exp(-u) lands on a diagonal entry some 1e3 times larger, so the one-ulp
differences between XLA's exp and torch's vanish in the sum)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysolvers_tpu as pst
import pysolvers_tpu_torch as pt
from pysolvers_tpu.linear.amg import AMG as JAMG
from pysolvers_tpu.linear.gmg import GMGPreconditionerType as JGMG
from pysolvers_tpu.problems import Bratu2D as JBratu
from pysolvers_tpu.problems.bratu import Bratu2DHostOuter as JHostOuter
from pysolvers_tpu_torch.problems import Bratu2D, Bratu2DHostOuter

torch.set_num_threads(1)
CPU = "cpu"


def _rel(x, y):
    x, y = np.asarray(x, dtype=np.float64), np.asarray(y, dtype=np.float64)
    return float(np.linalg.norm(x - y) / np.linalg.norm(y))


def _agree(st, sj, tol):
    assert st.reason == sj.reason
    assert st.iters == sj.iters
    assert st.success == sj.success
    soln = st.soln.numpy() if isinstance(st.soln, torch.Tensor) else st.soln
    assert _rel(soln, sj.soln) <= tol


# ---------------------------------------------------------------------------
# scalar Newton (examples/newton_example_root2.py, _arctan.py)
# ---------------------------------------------------------------------------

SCALAR = {
    "sqrt2": (lambda x: x * x - 2.0, lambda x: 2.0 * x, 1.0),
    "arctan": (np.arctan, lambda x: 1.0 / (1.0 + x * x), 2.0),
}


@pytest.mark.parametrize("name, linesearch, maxiter", [
    ("sqrt2", "backtrack", 20), ("sqrt2", "trivial", 20),
    ("arctan", "trivial", 20), ("arctan", "backtrack", 50)])
def test_scalar_newton_matches_jax(name, linesearch, maxiter):
    f, df, x0 = SCALAR[name]
    jls = (pst.TrivialLinesearch() if linesearch == "trivial"
           else pst.SimpleBacktrack())
    tls = (pt.TrivialLinesearch() if linesearch == "trivial"
           else pt.SimpleBacktrack())
    sj = pst.NewtonSolver(pst.SolverConfig(maxiter=maxiter, tau=1e-12),
                          linesearch=jls).solve(pst.FuncAdapter1D(f, df),
                                                jnp.asarray([x0]))
    st = pt.NewtonSolver(pt.SolverConfig(maxiter=maxiter, tau=1e-12),
                         linesearch=tls, device=CPU).solve(
        pt.FuncAdapter1D(f, df), torch.tensor([x0], dtype=torch.float64))
    assert st.reason == sj.reason and st.iters == sj.iters
    assert st.soln.dtype == torch.float64 and st.soln.device.type == "cpu"
    np.testing.assert_allclose(st.resid_history, sj.resid_history,
                               rtol=1e-10, atol=1e-300)
    if sj.success:
        np.testing.assert_allclose(float(st.soln[0]), float(sj.soln[0]),
                                   rtol=1e-12, atol=1e-12)


def test_scalar_newton_numpy_iterate_stays_numpy():
    f, df, x0 = SCALAR["sqrt2"]
    st = pt.NewtonSolver(pt.SolverConfig(maxiter=20, tau=1e-12),
                         device=CPU).solve(pt.FuncAdapter1D(f, df),
                                           np.array([x0], np.longdouble))
    assert isinstance(st.soln, np.ndarray) and st.soln.dtype == np.longdouble
    assert abs(float(st.soln[0]) - np.sqrt(2.0)) <= 1e-12


def test_trivial_linesearch_diverges_on_arctan():
    # reference NewtonExample_ArcTan.py: the full step diverges from x0 = 2
    f, df, _ = SCALAR["arctan"]
    st = pt.NewtonSolver(pt.SolverConfig(maxiter=20, tau=1e-12),
                         linesearch=pt.TrivialLinesearch(), device=CPU).solve(
        pt.FuncAdapter1D(f, df), torch.tensor([2.0], dtype=torch.float64))
    assert not st.success or abs(float(st.soln[0])) > 1e-6


# ---------------------------------------------------------------------------
# Bratu: the problem
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["dia", "ell"])
def test_bratu_jacobian_bit_equal(fmt):
    pj, pp = JBratu(m=6, fmt=fmt), Bratu2D(m=6, fmt=fmt, device=CPU)
    u = np.random.default_rng(0).random(36)
    Jh_j, Jd_j = pj.evalJ(jnp.asarray(u))
    Jh_t, Jd_t = pp.evalJ(torch.as_tensor(u))
    np.testing.assert_array_equal(Jh_t.data, Jh_j.data)
    np.testing.assert_array_equal(Jh_t.indices, Jh_j.indices)
    n = pp.n
    if fmt == "dia":
        assert Jd_t.offsets == tuple(Jd_j.offsets)
        np.testing.assert_array_equal(Jd_t.diags[:, :n].numpy(),
                                      np.asarray(Jd_j.diags)[:, :n])
        np.testing.assert_array_equal(
            pp.eval_j_dev(torch.as_tensor(u)).diags.numpy(),
            Jd_t.diags.numpy())
    else:
        np.testing.assert_array_equal(Jd_t.data[:n].numpy(),
                                      np.asarray(Jd_j.data)[:n])
        np.testing.assert_array_equal(Jd_t.cols[:n].numpy(),
                                      np.asarray(Jd_j.cols)[:n])
    # the stored operator is untouched, and F agrees
    stored_t = pp.A.diags[:, :n] if fmt == "dia" else pp.A.data[:n]
    stored_j = (np.asarray(pj.A.diags)[:, :n] if fmt == "dia"
                else np.asarray(pj.A.data)[:n])
    np.testing.assert_array_equal(stored_t.numpy(), stored_j)
    np.testing.assert_allclose(pp.evalF(torch.as_tensor(u)).numpy(),
                               np.asarray(pj.evalF(jnp.asarray(u))),
                               rtol=1e-13, atol=1e-12)
    v = np.random.default_rng(1).random(36)
    np.testing.assert_allclose(pt.matvec(Jd_t, torch.as_tensor(v)).numpy(),
                               Jh_t.matvec(v), rtol=1e-13)
    np.testing.assert_allclose(
        pp.jacobi_precond(Jd_t, torch.as_tensor(v)).numpy(),
        np.asarray(pj.jacobi_precond(Jd_j, jnp.asarray(v))), rtol=1e-15)


def test_bratu_host_outer_matches_jax():
    pj = JHostOuter(JBratu(m=12, fmt="dia"))
    pp = Bratu2DHostOuter(Bratu2D(m=12, fmt="dia", device=CPU))
    u = np.random.default_rng(3).random(144).astype(np.longdouble)
    np.testing.assert_array_equal(pp.evalF(u), pj.evalF(u))
    Jh_t, Jd_t = pp.evalJ(u)
    Jh_j, Jd_j = pj.evalJ(u)
    np.testing.assert_array_equal(Jh_t.data, Jh_j.data)
    np.testing.assert_array_equal(Jd_t.diags[:, :144].numpy(),
                                  np.asarray(Jd_j.diags)[:, :144])
    with pytest.raises(ValueError):
        Bratu2DHostOuter(Bratu2D(m=4, fmt="ell", device=CPU))


# ---------------------------------------------------------------------------
# Bratu: Newton with inner Krylov
# ---------------------------------------------------------------------------

def _bratu_pair(m, precision, amg=(5, 2), tau_inner=1e-12, maxiter=400):
    """The reference's Bratu driver (examples/bratu_example.py), in both
    packages: PCG + AMG inside Newton, tau = 1e-12, min_lin_tol = 1e-6,
    freeze_prec."""
    jinner = pst.PCG(pst.CommonSolverArgs(maxiter=maxiter, tau=tau_inner),
                     precond=JAMG(num_iters=amg[0], num_levels=amg[1]),
                     precision=precision)
    tinner = pt.PCG(pt.CommonSolverArgs(maxiter=maxiter, tau=tau_inner),
                    precond=pt.AMG(num_iters=amg[0], num_levels=amg[1]),
                    precision=precision, device=CPU)
    kw = dict(min_lin_tol=1e-6, freeze_prec=True)
    sj = pst.NewtonSolver(pst.SolverConfig(maxiter=30, tau=1e-12),
                          solver=jinner, **kw).solve(
        JBratu(m=m, alpha=0.5), jnp.zeros(m * m))
    st = pt.NewtonSolver(pt.SolverConfig(maxiter=30, tau=1e-12),
                         solver=tinner, device=CPU, **kw).solve(
        Bratu2D(m=m, alpha=0.5, device=CPU),
        torch.zeros(m * m, dtype=torch.float64))
    return st, sj


def test_bratu_newton_pcg_amg_matches_jax():
    st, sj = _bratu_pair(20, "native")
    assert sj.success
    _agree(st, sj, 1e-10)
    prob = Bratu2D(m=20, device=CPU)
    assert float(torch.linalg.norm(prob.evalF(st.soln))) <= 1e-10


def test_bratu_newton_mixed_matches_jax():
    # tests/test_mixed_factory.py::test_newton_bratu_mixed's configuration
    st, sj = _bratu_pair(20, "mixed")
    assert sj.success
    _agree(st, sj, 1e-8)
    assert st.soln.dtype == torch.float64


def test_freeze_prec_reuses_preconditioner():
    prob = Bratu2D(m=10, device=CPU)
    formed = []
    inner = pt.PCG(pt.CommonSolverArgs(maxiter=200, tau=1e-10),
                   precond=pt.AMG(num_iters=2, num_levels=2), device=CPU)
    form = inner.precond.form
    inner.precond.form = lambda *a, **k: formed.append(1) or form(*a, **k)
    st = pt.NewtonSolver(pt.SolverConfig(maxiter=20, tau=1e-10),
                         solver=inner, freeze_prec=True, device=CPU).solve(
        prob, torch.zeros(prob.n, dtype=torch.float64))
    assert st.success and st.iters >= 2 and len(formed) == 1
    # without the freeze every Newton step forms anew
    formed.clear()
    st2 = pt.NewtonSolver(pt.SolverConfig(maxiter=20, tau=1e-10),
                          solver=inner, device=CPU).solve(
        prob, torch.zeros(prob.n, dtype=torch.float64))
    assert len(formed) == st2.iters


def test_bratu_host_outer_newton_mixed_gmg_matches_jax():
    """benchmarks/bratu_large.py::run_ours at m = 31: longdouble host outer
    loop, mixed PCG + grid GMG (host Galerkin here, as the JAX package on
    its CPU backend), u0 = 1."""
    m, lev = 31, 2

    def run(pkg, prob, **kw):
        inner = pkg.PCG(pkg.CommonSolverArgs(maxiter=400, tau=1e-12),
                        precond=(JGMG if pkg is pst else pt.GMGPreconditionerType)(
                            dims=(m, m), num_iters=2, num_levels=lev,
                            smoother="jacobi"),
                        precision="mixed", **kw)
        return pkg.NewtonSolver(pkg.SolverConfig(maxiter=30, tau=1e-12),
                                solver=inner, min_lin_tol=1e-6,
                                freeze_prec=True, **kw).solve(
            prob, np.ones(m * m, dtype=np.longdouble))

    sj = run(pst, JHostOuter(JBratu(m=m, alpha=0.5)))
    prob = Bratu2DHostOuter(Bratu2D(m=m, alpha=0.5, device=CPU))
    st = run(pt, prob, device=CPU)
    assert sj.success
    _agree(st, sj, 1e-8)
    assert isinstance(st.soln, np.ndarray) and st.soln.dtype == np.longdouble
    r0 = np.linalg.norm(prob.evalF(np.ones(m * m)))
    assert np.linalg.norm(prob.evalF(st.soln)) <= r0 * 1e-12 + 1e-12


def test_inner_failure_stops_newton():
    prob = Bratu2D(m=10, device=CPU)
    inner = pt.PCG(pt.CommonSolverArgs(maxiter=1, tau=1e-12), device=CPU)
    st = pt.NewtonSolver(pt.SolverConfig(maxiter=20, tau=1e-12),
                         solver=inner, device=CPU).solve(
        prob, torch.zeros(prob.n, dtype=torch.float64))
    assert not st.success and st.reason == pt.StopReason.INNER_SOLVE_FAIL
    assert st.iters == 0 and len(st.resid_history) == 1
