"""The refinement drivers of ``linear/refine.py`` against the JAX package's
on fd_laplacian_2d(15) (n = 225, b from ``default_rng(3)``), f32 DIA inner
operators, tau = 1e-10: ``ir_solve`` (f64 residuals on the device),
``ir_solve_host`` (host residuals, f32 operator as ``A_lo``) and
``ir_solve_dd`` (the f64 DIA oracle and the host check) for CG, GMRES and
Richardson inners.  CG and GMRES take f32 Jacobi or nothing, Richardson
the f32 dense inverse (a stationary iteration needs a strong M).  Gates:
the same stop reason, total inner iterations within max(2, 5 %), and a
host-checked ‖b − Ax‖ <= tau‖b‖ on a CONVERGED solve; the solution is f64
on the operator's device."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysolvers_tpu as pst
from pysolvers_tpu.linear import refine as jref
import pysolvers_tpu_torch as pt
from pysolvers_tpu_torch.core import StopReason
from pysolvers_tpu_torch.linear import refine as tref

torch.set_num_threads(1)
TAU = 1e-10


@pytest.fixture(scope="module")
def sys15():
    Hj, Ht = pst.problems.fd_laplacian_2d(15), pt.problems.fd_laplacian_2d(15)
    b = Hj.matvec(np.random.default_rng(3).random(Hj.shape[0]))
    d32 = (1.0 / Hj.diagonal()).astype(np.float32)
    inv32 = np.linalg.inv(Hj.to_dense()).astype(np.float32)
    return dict(
        Hj=Hj, Ht=Ht, b=b,
        j32=pst.DiaMatrix.from_host_csr(Hj, dtype=np.float32),
        j64=pst.DiaMatrix.from_host_csr(Hj, dtype=np.float64),
        t32=pt.DiaMatrix.from_host_csr(Ht, dtype=np.float32, device="cpu"),
        t64=pt.DiaMatrix.from_host_csr(Ht, dtype=np.float64, device="cpu"),
        jprec={"jacobi": lambda v: jnp.asarray(d32) * v,
               "inv": lambda v: jnp.asarray(inv32) @ v, "none": None},
        tprec={"jacobi": lambda v: torch.as_tensor(d32) * v,
               "inv": lambda v: torch.as_tensor(inv32) @ v, "none": None})


def _agree(p, sj, xt, st):
    assert st.reason == int(sj.reason)
    kj = int(sj.k)
    assert abs(int(st.k) - kj) <= max(2, 0.05 * kj)
    assert xt.dtype == torch.float64 and xt.device.type == "cpu"
    if st.reason == StopReason.CONVERGED:
        r = p["b"] - p["Ht"].matvec(xt.numpy())
        assert np.linalg.norm(r) <= TAU * np.linalg.norm(p["b"])


INNERS = [("cg", "jacobi"), ("gmres", "jacobi"), ("richardson", "inv")]


@pytest.mark.parametrize("method,prec", INNERS)
def test_ir_solve_matches_jax(sys15, method, prec):
    p = sys15
    _, sj, _ = jref.ir_solve(
        lambda v: pst.matvec(p["j64"], v), lambda v: pst.matvec(p["j32"], v),
        jnp.asarray(p["b"]), tau=TAU, method=method,
        precond_lo=p["jprec"][prec], restart=30)
    xt, st, _ = tref.ir_solve(
        lambda v: pt.matvec(p["t64"], v), lambda v: pt.matvec(p["t32"], v),
        torch.as_tensor(p["b"]), tau=TAU, method=method,
        precond_lo=p["tprec"][prec], restart=30)
    _agree(p, sj, xt, st)


@pytest.mark.parametrize("method,prec", INNERS)
def test_ir_solve_host_matches_jax(sys15, method, prec):
    p = sys15
    _, sj, _ = jref.ir_solve_host(
        p["Hj"].matvec, None, p["b"], tau=TAU, method=method,
        precond_lo=p["jprec"][prec], restart=30, host_residual=True,
        A_lo=p["j32"], chain=2)
    xt, st, _ = tref.ir_solve_host(
        p["Ht"].matvec, None, p["b"], tau=TAU, method=method,
        precond_lo=p["tprec"][prec], restart=30, host_residual=True,
        A_lo=p["t32"], chain=2)
    _agree(p, sj, xt, st)


@pytest.mark.parametrize("method,prec", INNERS + [("cg", "none"),
                                                  ("gmres", "none")])
def test_ir_solve_dd_matches_jax(sys15, method, prec):
    """Preconditioned: one pass (residual replacement for CG, the f64
    recurrence for the others); GMRES unpreconditioned: chains of four f32
    passes with the floor-aware inner tolerance."""
    p = sys15
    _, sj, _ = jref.ir_solve_dd(
        p["Hj"].matvec, p["b"], A_lo=p["j32"], A64=p["j64"], tau=TAU,
        method=method, precond_lo=p["jprec"][prec], restart=30,
        inner_maxiter=1000)
    xt, st, _ = tref.ir_solve_dd(
        p["Ht"].matvec, p["b"], A_lo=p["t32"], A64=p["t64"], tau=TAU,
        method=method, precond_lo=p["tprec"][prec], restart=30,
        inner_maxiter=1000)
    _agree(p, sj, xt, st)
    assert st.reason == StopReason.CONVERGED
