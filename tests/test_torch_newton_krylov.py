"""Matrix-free Newton-Krylov of the port against the JAX package's
(``newton_krylov_solve``, Bratu m <= 16, f64): the same Newton steps and
stop reason, total inner iterations within ±1 per Newton step, solutions
within 1e-10 relative; and K1 under ``torch.func.jvp`` (its
``autograd.Function``): the tangent equals the product with the tangent
vector exactly (SpMV is linear; both run the same twin here)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysolvers_tpu.nonlinear.newton_krylov import newton_krylov_solve as jnk
from pysolvers_tpu.problems import Bratu2D as JBratu
from pysolvers_tpu_torch.core import StopReason
from pysolvers_tpu_torch.nonlinear import newton_krylov_solve
from pysolvers_tpu_torch.ops import spmv
from pysolvers_tpu_torch.problems import Bratu2D

torch.set_num_threads(1)


def _agree(x, st, xj, sj):
    assert st.reason == int(sj.reason) == StopReason.CONVERGED
    assert st.k == int(sj.k)
    assert abs(st.inner_total - int(sj.inner_total)) <= st.k
    assert st.inner_total > 0
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("fmt, method, m", [
    ("dia", "cg", 16), ("ell", "cg", 8), ("dia", "gmres", 8)])
def test_bratu_jvp_newton_matches_jax(fmt, method, m):
    kw = dict(tau=1e-12, maxiter=30, inner_maxiter=300, method=method,
              min_lin_tol=1e-8)
    pj, pp = JBratu(m=m, fmt=fmt), Bratu2D(m=m, fmt=fmt, device="cpu")
    xj, sj = jnk(pj.eval_f, jnp.zeros(pj.n), **kw)
    x, st = newton_krylov_solve(pp.eval_f,
                                torch.zeros(pp.n, dtype=torch.float64),
                                device="cpu", **kw)
    _agree(x, st, xj, sj)
    assert float(torch.linalg.norm(pp.eval_f(x))) <= 1e-10


@pytest.mark.parametrize("jacobi", [False, True])
def test_bratu_explicit_j_matches_jax(jacobi):
    m = 16
    pj, pp = JBratu(m=m), Bratu2D(m=m, device="cpu")
    kw = dict(tau=1e-12, maxiter=30, inner_maxiter=500, method="cg",
              min_lin_tol=1e-8)
    xj, sj = jnk(pj.eval_f, jnp.zeros(pj.n), eval_j=pj.eval_j_dev,
                 precond_from_j=pj.jacobi_precond if jacobi else None, **kw)
    x, st = newton_krylov_solve(
        pp.eval_f, torch.zeros(pp.n, dtype=torch.float64), device="cpu",
        eval_j=pp.eval_j_dev,
        precond_from_j=pp.jacobi_precond if jacobi else None, **kw)
    _agree(x, st, xj, sj)
    # the explicit-J and matrix-free iterates meet
    xm, _ = newton_krylov_solve(pp.eval_f,
                                torch.zeros(pp.n, dtype=torch.float64),
                                device="cpu", **kw)
    np.testing.assert_allclose(x.numpy(), xm.numpy(), atol=1e-9)


def test_scalar_system_matches_jax():
    def Fj(x):
        return jnp.array([x[0] ** 2 - 2.0])

    def Ft(x):
        return torch.stack([x[0] ** 2 - 2.0])

    xj, sj = jnk(Fj, jnp.asarray([1.0]), tau=1e-13, inner_maxiter=5,
                 method="gmres")
    x, st = newton_krylov_solve(Ft, np.array([1.0]), tau=1e-13,
                                inner_maxiter=5, method="gmres",
                                device="cpu")
    assert st.reason == int(sj.reason) and st.k == int(sj.k)
    np.testing.assert_allclose(float(x[0]), np.sqrt(2.0), rtol=1e-10)


def test_converged_start_and_linesearch_failure():
    p = Bratu2D(m=6, device="cpu")
    x0 = torch.zeros(p.n, dtype=torch.float64)
    x, st = newton_krylov_solve(p.eval_f, x0, tau=1e6, device="cpu")
    assert st == (0, 0, st.resid, StopReason.CONVERGED) and x is x0
    with pytest.raises(RuntimeError, match="device"):
        newton_krylov_solve(p.eval_f, x0)           # no card here
    # x² + 1 has no root: Newton reaches x = 0, where J = 0 and no trial
    # decreases ||F||
    xj, sj = jnk(lambda x: jnp.array([x[0] ** 2 + 1.0]), jnp.asarray([1.0]),
                 tau=1e-12, inner_maxiter=5)
    x, st = newton_krylov_solve(lambda x: torch.stack([x[0] ** 2 + 1.0]),
                                np.array([1.0]), tau=1e-12, inner_maxiter=5,
                                device="cpu")
    assert st.reason == int(sj.reason) == StopReason.LINESEARCH_FAIL
    assert st.k == int(sj.k) and float(x[0]) == float(xj[0]) == 0.0


def test_k1_function_carries_the_tangent(monkeypatch):
    """On a transformed tensor dia_spmv takes its autograd.Function: the
    forward on the unwrapped x, the tangent by a second product."""
    p = Bratu2D(m=7, device="cpu")
    rng = np.random.default_rng(0)
    x, v = (torch.as_tensor(rng.random(p.n)) for _ in range(2))
    calls = []
    jvp = spmv._DiaSpmvFn.jvp
    monkeypatch.setattr(spmv._DiaSpmvFn, "jvp", staticmethod(
        lambda ctx, *t: calls.append(1) or jvp(ctx, *t)))
    y, t = torch.func.jvp(lambda u: spmv.dia_spmv(p.A, u), (x,), (v,))
    assert calls == [1]
    assert torch.equal(y, spmv.dia_spmv_torch(p.A, x))
    assert torch.equal(t, spmv.dia_spmv_torch(p.A, v))
    # through F: J·v = A v + alpha e^{-x} v
    _, t = torch.func.jvp(p.eval_f, (x,), (v,))
    np.testing.assert_allclose(
        t.numpy(), (spmv.dia_spmv_torch(p.A, v)
                    + p.alpha * torch.exp(-x) * v).numpy(), rtol=1e-14)
def test_tangent_products_reach_the_launch_branch_flagged(monkeypatch):
    """Each product made for a tangent reaches dia_spmv's launch branch
    (an unwrapped tensor) once, flagged, so that on CUDA the launch itself
    counts it in ``dia_spmv_jvp_launches``; nested jvps count each of
    their products once: A x (primal), A v and A w (tangents)."""
    p = Bratu2D(m=5, device="cpu")
    rng = np.random.default_rng(1)
    x, v, w = (torch.as_tensor(rng.random(p.n)) for _ in range(3))
    flags = []
    real = spmv.dia_spmv

    def recorded(A, u, *, _tangent=False):
        if not spmv._functorch_wrapped(u):
            flags.append(_tangent)
        return real(A, u, _tangent=_tangent)
    monkeypatch.setattr(spmv, "dia_spmv", recorded)
    torch.func.jvp(lambda u: spmv.dia_spmv(p.A, u), (x,), (v,))
    assert flags == [False, True]
    flags.clear()
    g = lambda u: torch.func.jvp(                            # noqa: E731
        lambda z: spmv.dia_spmv(p.A, z) * z, (u,), (v,))[1]
    _, t = torch.func.jvp(g, (x,), (w,))
    assert flags == [False, True, True]
    Av, Aw = spmv.dia_spmv_torch(p.A, v), spmv.dia_spmv_torch(p.A, w)
    np.testing.assert_allclose(t.numpy(), (Aw * v + Av * w).numpy(),
                               rtol=1e-14)


