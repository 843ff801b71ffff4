"""The mixed-precision Krylov solvers of the port against the JAX package on
the same seeded inputs (numpy, f32 operators beside f64 oracles):

* ``cg_solve_rr`` on fd_laplacian_2d(31) (n = 961), the f32 DIA operator
  with the f64 DIA oracle, unpreconditioned, Jacobi and two-level SA-AMG
  (formed on the f32 host matrix in both packages), with the f32 and the
  f64 recurrence: the same stop reason, iterations within ±1, x within
  1e-6 relative (the f32 recurrences round the same operations in the same
  order — the port's ``addcmul`` rounds once like XLA's fused
  multiply-adds — up to the f64 dots' summation order), and with f32
  dots (``hi_dots=False``);
* the STALL guard on an overflowing preconditioner (both stop at
  iteration 1 with the best replaced iterate, zero, and its residual);
* ``richardson_solve`` with damped Jacobi on fd_laplacian_2d(7): the same
  iterations and x within 1e-12;
* ``cg_lockstep_rr`` and ``ir_solve_multi`` on fd_vector_laplacian_2d(24,
  b=5) at k = 3 in the row layout, block-Jacobi through the D = 1
  BdiaMatrix: per column the same reason, iterations within ±1, X within
  1e-6;
* host reads of ``cg_solve_rr``: one per iteration, one more per
  replacement and the start's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysolvers_tpu as pst
from pysolvers_tpu.linear import block_precond as jbp
from pysolvers_tpu.linear import krylov as jk
from pysolvers_tpu.linear import refine as jref
from pysolvers_tpu.linear.preconditioner import (
    JacobiPreconditionerType as JaxJacobi)
from pysolvers_tpu.ops import spmv as jspmv
from pysolvers_tpu.problems.laplacian import fd_vector_laplacian_2d as jvec
from pysolvers_tpu.sparse.bdia import BdiaMatrix as JaxBdia
from pysolvers_tpu.sparse.host import HostCSR as JaxCSR
import pysolvers_tpu_torch as pt
from pysolvers_tpu_torch.core import StopReason
from pysolvers_tpu_torch.linear import block_precond as tbp
from pysolvers_tpu_torch.linear import krylov as tk
from pysolvers_tpu_torch.linear import refine as tref
from pysolvers_tpu_torch.ops import spmv

torch.set_num_threads(1)


def _rel(x, y):
    x, y = np.asarray(x), np.asarray(y)
    return float(np.linalg.norm(x - y) / np.linalg.norm(y))


def _f32(H):
    return type(H)(H.indptr, H.indices, H.data.astype(np.float32), H.shape)


@pytest.fixture(scope="module")
def lap31():
    """fd_laplacian_2d(31): host matrices, f32/f64 DIA operators of both
    packages and a right-hand side scaled to norm 1."""
    Hj, Ht = pst.problems.fd_laplacian_2d(31), pt.problems.fd_laplacian_2d(31)
    b = Hj.matvec(np.random.default_rng(2).random(Hj.shape[0]))
    return dict(
        Hj=Hj, Ht=Ht, b=b / np.linalg.norm(b),
        j32=pst.DiaMatrix.from_host_csr(Hj, dtype=np.float32),
        j64=pst.DiaMatrix.from_host_csr(Hj, dtype=np.float64),
        t32=pt.DiaMatrix.from_host_csr(Ht, dtype=np.float32, device="cpu"),
        t64=pt.DiaMatrix.from_host_csr(Ht, dtype=np.float64, device="cpu"))


def _preconds(p, name):
    """(JAX apply, port apply) of the named f32 preconditioner."""
    if name == "none":
        return None, None
    if name == "jacobi":
        return (JaxJacobi().form(_f32(p["Hj"])).apply_any,
                pt.JacobiPreconditionerType().form(_f32(p["Ht"]),
                                                   device="cpu").apply_any)
    return (pst.AMG(num_iters=1, num_levels=2).form(_f32(p["Hj"]),
                                                    p["j32"]).apply_any,
            pt.AMG(num_iters=1, num_levels=2).form(_f32(p["Ht"]),
                                                   device="cpu").apply_any)


def _rr_pair(p, pj, ptt, hi, scale=1.0, **kw):
    mj = None if pj is None else (lambda v: pj(v) * scale)
    mt = None if ptt is None else (lambda v: ptt(v) * scale)
    xj, sj, _ = jk.cg_solve_rr(
        lambda v: pst.matvec(p["j32"], v), jnp.asarray(p["b"]),
        mv_hi=lambda v: pst.matvec(p["j64"], v), precond=mj,
        hi_matvec=hi, **kw)
    xt, st, _ = tk.cg_solve_rr(
        lambda v: pt.matvec(p["t32"], v), torch.as_tensor(p["b"]),
        mv_hi=lambda v: pt.matvec(p["t64"], v), precond=mt,
        hi_matvec=hi, **kw)
    return (np.asarray(xj), sj), (xt, st)


@pytest.mark.parametrize("hi", [False, True], ids=["f32_rec", "f64_rec"])
@pytest.mark.parametrize("prec", ["none", "jacobi", "amg"])
def test_cg_solve_rr_matches_jax(lap31, prec, hi):
    pj, ptt = _preconds(lap31, prec)
    (xj, sj), (xt, st) = _rr_pair(lap31, pj, ptt, hi, maxiter=500,
                                  tau=1e-10)
    assert st.reason == int(sj.reason) == StopReason.CONVERGED
    assert abs(st.k - int(sj.k)) <= 1
    assert xt.dtype == torch.float64
    assert _rel(xt.numpy(), xj) <= 1e-6
    # converged on a replaced (true) residual
    r = lap31["b"] - lap31["Ht"].matvec(xt.numpy())
    assert np.linalg.norm(r) <= 1e-10 * 1.01


def test_cg_solve_rr_f32_dots_match_jax(lap31):
    """hi_dots=False: the dots and norms reduce in f32, as in the JAX
    package."""
    (xj, sj), (xt, st) = _rr_pair(lap31, None, None, False, maxiter=500,
                                  tau=1e-10, hi_dots=False)
    assert st.reason == int(sj.reason) == StopReason.CONVERGED
    assert abs(st.k - int(sj.k)) <= 1
    assert _rel(xt.numpy(), xj) <= 1e-6


def test_stall_guard_matches_jax(lap31):
    """A preconditioner that overflows f32 makes the first recurrence
    residual NaN: both stop with STALL at once and return the best replaced
    iterate (x0 = 0) with its residual."""
    ident = lambda v: v                                 # noqa: E731
    (xj, sj), (xt, st) = _rr_pair(lap31, ident, ident, False, scale=1e38,
                                  maxiter=300, tau=1e-10)
    assert int(sj.reason) == st.reason == StopReason.STALL
    assert int(sj.k) == st.k == 1
    assert not xj.any() and not xt.any()
    assert float(st.resid) == pytest.approx(float(sj.resid), rel=1e-12)


def test_host_reads_per_iteration(lap31, monkeypatch):
    """One read per iteration, a second on each replacement, one at the
    start: with replace_every = 6 and no early trigger, k + k//6 + 1."""
    reads = []
    monkeypatch.setattr(tk, "_host", lambda t: reads.append(1) or
                        t.cpu().numpy())
    _, st, _ = tk.cg_solve_rr(
        lambda v: pt.matvec(lap31["t32"], v), torch.as_tensor(lap31["b"]),
        mv_hi=lambda v: pt.matvec(lap31["t64"], v), maxiter=20, tau=1e-10,
        replace_drop=0.0)
    assert st.reason == StopReason.MAXITER and st.k == 20
    # MAXITER reads the last u·r once more
    assert len(reads) == 20 + 20 // 6 + 1 + 1


def test_richardson_matches_jax():
    Hj, Ht = pst.problems.fd_laplacian_2d(7), pt.problems.fd_laplacian_2d(7)
    b = Hj.matvec(np.random.default_rng(4).random(Hj.shape[0]))
    dinv = 0.8 / Hj.diagonal()
    Aj = pst.DiaMatrix.from_host_csr(Hj)
    At = pt.DiaMatrix.from_host_csr(Ht, device="cpu")
    xj, sj, _ = jk.richardson_solve(
        lambda v: pst.matvec(Aj, v), jnp.asarray(b), maxiter=2000, tau=1e-8,
        precond=lambda v: jnp.asarray(dinv) * v)
    xt, st, _ = tk.richardson_solve(
        lambda v: pt.matvec(At, v), torch.as_tensor(b), maxiter=2000,
        tau=1e-8, precond=lambda v: torch.as_tensor(dinv) * v)
    assert st.reason == int(sj.reason) == StopReason.CONVERGED
    assert st.k == int(sj.k) > 10
    assert _rel(xt.numpy(), np.asarray(xj)) <= 1e-12
    _, s1, _ = tk.richardson_solve(
        lambda v: pt.matvec(At, v), torch.as_tensor(b), maxiter=3, tau=1e-8,
        precond=lambda v: torch.as_tensor(dinv) * v)
    assert s1.k == 3 and s1.reason == StopReason.MAXITER


@pytest.fixture(scope="module")
def block24():
    """fd_vector_laplacian_2d(24, b=5): f32/f64 packs of both packages,
    their f32 block-Jacobi inverses as D = 1 packs, and three planar f64
    right-hand sides in rows."""
    Ht = pt.fd_vector_laplacian_2d(24, b=5, coupling=0.2)
    Hj = jvec(24, b=5, coupling=0.2)
    Jh = JaxBdia.from_host_csr(JaxCSR(Hj.indptr, Hj.indices, Hj.data,
                                      Hj.shape), 5)
    Th = pt.BdiaMatrix.from_host_csr(Ht, 5, device="cpu")
    J32, T32 = Jh.astype(jnp.float32), Th.astype(torch.float32)
    B = np.stack([Ht.matvec(np.random.default_rng(s).random(Ht.shape[0]))
                  for s in range(3)])
    rows = np.stack([np.asarray(Th.to_planar(torch.as_tensor(v)))
                     for v in B])
    return dict(J32=J32, J64=Jh, T32=T32, T64=Th, rows=rows,
                Mj=jbp.block_jacobi_bdia_matrix(J32),
                Mt=tbp.block_jacobi_bdia_matrix(T32))


def _per_column(Xt, st, Xj, sj, tol=1e-6):
    np.testing.assert_array_equal(np.asarray(st.reason),
                                  np.asarray(sj.reason))
    assert (np.asarray(st.reason) == StopReason.CONVERGED).all()
    assert np.abs(np.asarray(st.k) - np.asarray(sj.k)).max() <= 1
    for c in range(Xt.shape[0]):
        assert _rel(Xt[c].numpy(), np.asarray(Xj)[c]) <= tol


def test_cg_lockstep_rr_matches_jax(block24):
    p = block24
    rows_dot = dict(dot=lambda a, c: jnp.sum(a * c, axis=1),
                    bc=lambda s: s[:, None], n_rhs=3)
    Xj, sj, _ = jk.cg_lockstep_rr(
        lambda V: jspmv.bdia_spmm_rows(p["J32"], V), jnp.asarray(p["rows"]),
        mm_hi=lambda V: jspmv.bdia_spmm_rows(p["J64"], V), maxiter=2000,
        tau=1e-10, precond=lambda V: jspmv.bdia_spmm_rows(p["Mj"], V),
        replace_every=48, **rows_dot)
    launches = spmv.bdia_spmm_launches
    Xt, st, _ = tk.cg_lockstep_rr(
        lambda V: spmv.bdia_spmm_rows(p["T32"], V),
        torch.as_tensor(p["rows"]),
        mm_hi=lambda V: spmv.bdia_spmm_rows(p["T64"], V), maxiter=2000,
        tau=1e-10, precond=lambda V: spmv.bdia_spmm_rows(p["Mt"], V),
        replace_every=48)
    assert spmv.bdia_spmm_launches == launches          # CPU: the twin
    assert Xt.dtype == torch.float64
    _per_column(Xt, st, Xj, sj)


def test_ir_solve_multi_matches_jax(block24):
    p = block24

    def jinner(R32, tau32):
        D, s, _ = jk.cg_solve_multi_rows(
            lambda V: jspmv.bdia_spmm_rows(p["J32"], V), R32, maxiter=2000,
            tau=tau32, precond=lambda V: jspmv.bdia_spmm_rows(p["Mj"], V))
        return D, s.k

    def tinner(R32, tau32):
        D, s, _ = tk.cg_solve_multi_rows(
            lambda V: spmv.bdia_spmm_rows(p["T32"], V), R32, maxiter=2000,
            tau=tau32, precond=lambda V: spmv.bdia_spmm_rows(p["Mt"], V))
        return D, s.k

    Xj, sj, _ = jref.ir_solve_multi(
        lambda V: jspmv.bdia_spmm_rows(p["J64"], V), jnp.asarray(p["rows"]),
        inner_solve=jinner,
        col_norm=lambda V: jnp.sqrt(jnp.sum(V * V, axis=1)),
        bc=lambda s: s[:, None], tau=1e-10)
    Xt, st, _ = tref.ir_solve_multi(
        lambda V: spmv.bdia_spmm_rows(p["T64"], V),
        torch.as_tensor(p["rows"]), inner_solve=tinner,
        col_norm=lambda V: torch.sqrt(torch.sum(V * V, dim=1)),
        bc=lambda s: s[:, None], tau=1e-10)
    _per_column(Xt, st, Xj, sj)
    # the f64 residuals the port reports are the columns' own
    R = p["rows"] - spmv.bdia_spmm_rows(p["T64"], Xt).numpy()
    np.testing.assert_allclose(np.asarray(st.resid),
                               np.linalg.norm(R, axis=1), rtol=1e-12)
    assert (np.asarray(st.resid)
            <= 1e-10 * np.linalg.norm(p["rows"], axis=1)).all()
