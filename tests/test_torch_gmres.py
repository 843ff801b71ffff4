"""GMRES, Arnoldi, the direct solve and the slice's ``solve()`` routes of
the port against the JAX package on the same seeded inputs (f64, sizes
m <= 31): the same stop reason, iterations within ±1 and solutions within
1e-8 relative at tau = 1e-10 (the two loops round the Gram-Schmidt dots in
different orders, and the rotations run on the host here), Arnoldi's Q and
H within 1e-10."""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysolvers_tpu as pst
import pysolvers_tpu_torch as pt
from pysolvers_tpu.linear import arnoldi as jarn
from pysolvers_tpu.linear.krylov import gmres_solve as jax_gmres
from pysolvers_tpu.problems.laplacian import fd_convection_diffusion_2d as cdj
from pysolvers_tpu_torch.core import StopReason
from pysolvers_tpu_torch.linear import arnoldi as tarn
from pysolvers_tpu_torch.linear import krylov as tkrylov
from pysolvers_tpu_torch.linear.krylov import gmres_solve
from pysolvers_tpu_torch.ops import spmv

torch.set_num_threads(1)


def _convdiff(m=15, seed=2):
    Hj, Ht = cdj(m), pt.fd_convection_diffusion_2d(m)
    x_star = np.random.default_rng(seed).random(Hj.shape[0])
    return Hj, Ht, x_star, Hj.matvec(x_star)


def _rel(x, y):
    x, y = np.asarray(x), np.asarray(y)
    return float(np.linalg.norm(x - y) / np.linalg.norm(y))


def _agree(st, sj, tol=1e-8):
    assert st.reason == sj.reason
    assert abs(st.iters - sj.iters) <= 1
    assert _rel(st.soln.numpy(), sj.soln) <= tol


# ---------------------------------------------------------------------------
# Givens and Arnoldi
# ---------------------------------------------------------------------------

def test_givens_matches_jax():
    for a, b in ((3.0, 4.0), (0.0, 0.0), (-2.0, 1e-300), (1e19, 1e19)):
        cj, sj = jarn.givens_coefficients(jnp.float64(a), jnp.float64(b))
        ct, st = tarn.givens_coefficients(torch.tensor(a, dtype=torch.float64),
                                          torch.tensor(b, dtype=torch.float64))
        np.testing.assert_allclose([float(ct), float(st)],
                                   [float(cj), float(sj)], rtol=1e-15)
    # f32 stays finite where a*a would overflow
    c, s = tarn.givens_coefficients(torch.tensor(1e30), torch.tensor(1e30))
    assert abs(float(c) - 2 ** -0.5) < 1e-6 and abs(float(s) - 2 ** -0.5) < 1e-6
    v = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
    vj = jarn.apply_givens(jnp.asarray(v.numpy()), 0.6, 0.8, 0, 2)
    vt = tarn.apply_givens(v, 0.6, 0.8, 0, 2)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-15)
    assert v[0] == 1.0                    # a new tensor


@pytest.mark.parametrize("method", ["mgs", "cgs"])
def test_arnoldi_matches_jax(method):
    Hj, Ht, _, b = _convdiff(7)
    Aj = pst.DiaMatrix.from_host_csr(Hj)
    At = pt.DiaMatrix.from_host_csr(Ht, device="cpu")
    Qj, Hhj = jarn.arnoldi(lambda v: pst.matvec(Aj, v), jnp.asarray(b), 12,
                           method)
    Qt, Hht = tarn.arnoldi(lambda v: pt.matvec(At, v), torch.from_numpy(b),
                           12, method)
    assert np.abs(Qt.numpy() - np.asarray(Qj)).max() <= 1e-10
    assert (np.abs(Hht.numpy() - np.asarray(Hhj)).max()
            <= 1e-10 * np.abs(np.asarray(Hhj)).max())
    fj, oj = jarn.arnoldi_residual(lambda v: pst.matvec(Aj, v), Qj, Hhj)
    ft, ot = tarn.arnoldi_residual(lambda v: pt.matvec(At, v), Qt, Hht)
    scale = float(np.abs(np.asarray(Hhj)).max())
    assert float(ft) <= 1e-12 * scale and float(fj) <= 1e-12 * scale
    assert float(ot) <= 1e-12 and abs(float(ot) - float(oj)) <= 1e-12


# ---------------------------------------------------------------------------
# gmres_solve
# ---------------------------------------------------------------------------

CASES = {
    "mgs_full": dict(orthog="mgs"),
    "cgs2_full": dict(orthog="cgs2"),
    "mgs_restart_flexible": dict(orthog="mgs", restart=20, flexible=True),
    "cgs2_restart": dict(orthog="cgs2", restart=20),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gmres_matches_jax(case):
    kw = CASES[case]
    Hj, Ht, _, b = _convdiff(15)
    Aj = pst.DiaMatrix.from_host_csr(Hj)
    At = pt.DiaMatrix.from_host_csr(Ht, device="cpu")
    dj = jnp.asarray(1.0 / Hj.diagonal())
    dt = torch.from_numpy(1.0 / Ht.diagonal())
    xj, sj, hj = jax_gmres(lambda v: pst.matvec(Aj, v), jnp.asarray(b),
                           maxiter=300, tau=1e-10, precond=lambda v: dj * v,
                           **kw)
    seen = []
    xt, st, ht = gmres_solve(lambda v: pt.matvec(At, v), torch.from_numpy(b),
                             maxiter=300, tau=1e-10, precond=lambda v: dt * v,
                             iter_callback=lambda k, r: seen.append((k, r)),
                             **kw)
    assert int(sj.reason) == st.reason == StopReason.CONVERGED
    assert abs(int(sj.k) - st.k) <= 1
    assert _rel(xt.numpy(), xj) <= 1e-8
    assert abs(float(st.resid) - float(sj.resid)) <= 1e-9 * np.linalg.norm(b)
    k = min(int(sj.k), st.k)
    np.testing.assert_allclose(ht.numpy()[: k + 1], np.asarray(hj)[: k + 1],
                               rtol=1e-6)
    assert np.isnan(ht.numpy()[st.k + 1:]).all()
    assert [s[0] for s in seen] == list(range(1, st.k + 1))
    assert seen[-1][1] == ht.numpy()[st.k]


def test_gmres_maxiter_trivial_b_and_one_read_per_iteration(monkeypatch):
    """MAXITER at maxiter, no iteration for b = 0, and one host read per
    iteration (plus one per cycle, the |b| read and the true residual's)."""
    Hj, Ht, _, b = _convdiff(9)
    At = pt.DiaMatrix.from_host_csr(Ht, device="cpu")
    reads = []
    real = tkrylov._host
    monkeypatch.setattr(tkrylov, "_host", lambda t: reads.append(1) or real(t))
    for maxiter, restart in ((7, None), (12, 5)):
        reads.clear()
        x, st, _ = gmres_solve(lambda v: pt.matvec(At, v), torch.from_numpy(b),
                               maxiter=maxiter, restart=restart, tau=1e-14)
        assert st.reason == StopReason.MAXITER and st.k == maxiter
        cycles = -(-maxiter // (restart or maxiter))
        assert len(reads) == maxiter + cycles + 1
    x, st, _ = gmres_solve(lambda v: pt.matvec(At, v),
                           torch.zeros(Ht.shape[0], dtype=torch.float64),
                           maxiter=5, tau=1e-10)
    assert st.reason == StopReason.CONVERGED and st.k == 0
    assert not x.any()
    with pytest.raises(ValueError, match="orthog"):
        gmres_solve(lambda v: v, torch.ones(3), orthog="householder")


def test_true_residual_mismatch_matches_jax():
    """A nonlinear preconditioner breaks x = x0 + M(Q y): the implicit
    residual converges, the true one does not, and both packages report
    TRUE_RESID_MISMATCH; FGMRES forms x from Z and converges."""
    Hj, Ht, _, b = _convdiff(9)
    Aj = pst.DiaMatrix.from_host_csr(Hj)
    At = pt.DiaMatrix.from_host_csr(Ht, device="cpu")
    scale = 1.0 / Hj.diagonal()[0]
    _, sj, _ = jax_gmres(lambda v: pst.matvec(Aj, v), jnp.asarray(b),
                         maxiter=100, tau=1e-10,
                         precond=lambda v: scale * (v + 0.3 * jnp.abs(v)))
    nonlinear = lambda v: scale * (v + 0.3 * torch.abs(v))   # noqa: E731
    _, st, _ = gmres_solve(lambda v: pt.matvec(At, v), torch.from_numpy(b),
                           maxiter=100, tau=1e-10, precond=nonlinear)
    assert (int(sj.reason) == st.reason
            == StopReason.TRUE_RESID_MISMATCH)
    assert abs(int(sj.k) - st.k) <= 1
    x, st, _ = gmres_solve(lambda v: pt.matvec(At, v), torch.from_numpy(b),
                           maxiter=100, tau=1e-10, precond=nonlinear,
                           flexible=True)
    assert st.reason == StopReason.CONVERGED
    assert np.linalg.norm(b - Ht.matvec(x.numpy())) <= 1e-9 * np.linalg.norm(b)


# ---------------------------------------------------------------------------
# The GMRES factory with ILUT on either side (tests/test_api.py:24-40,
# tests/test_solve_api.py:179-211)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side", ["left", "right", "both"])
def test_gmres_factory_ilut_matches_jax(side):
    Hj, Ht, x_star, b = _convdiff(15, seed=5)
    ctl = dict(maxiter=400, tau=1e-10)
    sj = pst.GMRES(pst.CommonSolverArgs(**ctl),
                   precond=pst.ILUTPreconditionerType(1e-3, 15, side=side)
                   ).make_solver().solve(Hj, b)
    st = pt.GMRES(pt.CommonSolverArgs(**ctl),
                  precond=pt.ILUTPreconditionerType(1e-3, 15, side=side),
                  device="cpu").make_solver().solve(Ht, b)
    assert st.success and st.soln.device.type == "cpu"
    _agree(st, sj)
    assert _rel(st.soln.numpy(), x_star) <= 1e-6
    # the true residual of the ORIGINAL system is reported
    r = np.linalg.norm(Ht.matvec(st.soln.numpy()) - b)
    assert abs(st.resid - r) / r < 1e-3


def test_gmres_generic_preconditioner_applies_once():
    """A generic (side="both") preconditioner is one apply, on the right:
    the same iterations as the right-side one."""
    _, Ht, _, b = _convdiff(15)
    ctl = pt.CommonSolverArgs(maxiter=400, tau=1e-10)
    st_b = pt.GMRES(ctl, precond=pt.JacobiPreconditionerType(side="both"),
                    device="cpu").make_solver().solve(Ht, b)
    st_r = pt.GMRES(ctl, precond=pt.JacobiPreconditionerType(side="right"),
                    device="cpu").make_solver().solve(Ht, b)
    assert st_b.success and st_r.success and st_b.iters == st_r.iters
    with pytest.raises(ValueError, match="orthog"):
        pt.GMRES(orthog="cgs", device="cpu")
    with pytest.raises(ValueError, match="solve\\(A, B\\)"):
        pt.GMRES(device="cpu").make_solver().solve(Ht, np.stack([b, b], 1))


# ---------------------------------------------------------------------------
# The direct solve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["host", "dense", "dia", "ell"])
def test_direct_matches_jax(form):
    H = pt.problems.fd_laplacian_2d(9)
    Hj = pst.problems.fd_laplacian_2d(9)
    x_star = np.random.default_rng(6).random(81)
    b = H.matvec(x_star)
    A, Aj = {"host": (H, Hj), "dense": (H.to_dense(), Hj.to_dense()),
             "dia": (pt.DiaMatrix.from_host_csr(H, device="cpu"),
                     pst.DiaMatrix.from_host_csr(Hj)),
             "ell": (pt.EllMatrix.from_host_csr(H, device="cpu"),
                     pst.EllMatrix.from_host_csr(Hj))}[form]
    st = pt.DefaultDirect(device="cpu").make_solver().solve(A, b)
    sj = pst.DefaultDirect().make_solver().solve(Aj, b)
    assert st.success and sj.success and st.iters == sj.iters == 1
    assert st.soln.device.type == "cpu"
    assert _rel(st.soln.numpy(), sj.soln) <= 1e-12
    assert _rel(st.soln.numpy(), x_star) <= 1e-12


def test_direct_failures_are_wrapped():
    A = np.ones((4, 4))
    st = pt.DefaultDirect(device="cpu").make_solver().solve(A, np.ones(4))
    sj = pst.DefaultDirect().make_solver().solve(A, np.ones(4))
    assert not st.success and not sj.success
    assert st.reason == sj.reason == StopReason.BREAKDOWN
    big = pt.problems.fd_laplacian_2d(142)           # n = 20,164
    st = pt.DefaultDirect(device="cpu").make_solver().solve(big, np.ones(20164))
    assert not st.success and "densify limit" in st.msg


# ---------------------------------------------------------------------------
# solve() with its defaults (tests/test_solve_api.py:11-30)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["direct", "ic", "gmres_ilut"])
def test_solve_defaults_match_jax(route, monkeypatch):
    tsolve = sys.modules["pysolvers_tpu_torch.solve"]
    made = []
    for name in ("DefaultDirect", "PCG", "GMRES"):
        real = getattr(tsolve, name)
        monkeypatch.setattr(
            tsolve, name,
            (lambda real, name: lambda *a, **k: made.append(
                (name, k.get("precond"))) or real(*a, **k))(real, name))
    if route == "direct":
        Hj, Ht = pst.problems.fd_laplacian_2d(20), pt.problems.fd_laplacian_2d(20)
    elif route == "ic":
        Hj, Ht = pst.problems.fd_laplacian_2d(26), pt.problems.fd_laplacian_2d(26)
    else:
        Hj, Ht = cdj(24), pt.fd_convection_diffusion_2d(24)
    x_star = np.random.default_rng(7).random(Hj.shape[0])
    b = Hj.matvec(x_star)
    st = pt.solve(Ht, b, tau=1e-10, device="cpu")
    sj = pst.solve(Hj, b, tau=1e-10)
    name, prec = made[0]
    assert name == {"direct": "DefaultDirect", "ic": "PCG",
                    "gmres_ilut": "GMRES"}[route]
    assert type(prec).__name__ == {
        "direct": "NoneType", "ic": "ICPreconditionerType",
        "gmres_ilut": "ILUTPreconditionerType"}[route]
    assert st.success and st.soln.device.type == "cpu"
    _agree(st, sj)
    assert _rel(st.soln.numpy(), x_star) <= 1e-6


def test_solve_forwards_gmres_options():
    _, Ht, x_star, b = _convdiff(15)
    st = pt.solve(Ht, b, tau=1e-10, method="gmres", precond="jacobi",
                  restart=10, orthog="cgs2", flexible=True, device="cpu")
    assert st.success and _rel(st.soln.numpy(), x_star) <= 1e-6
    with pytest.raises(TypeError, match="unexpected"):
        pt.solve(Ht, b, restarts=10, device="cpu")
    with pytest.raises(ValueError, match="orthog"):
        pt.solve(Ht, b, method="gmres", orthog="cgs", device="cpu")


# ---------------------------------------------------------------------------
# The block lane: GMRES (K4's twin here) and scalar IC
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,precond", [("gmres", "auto"), ("cg", "ic"),
                                            ("gmres", "ic")])
def test_block_lane_matches_jax(method, precond):
    Hj = pst.problems.fd_vector_laplacian_2d(12, b=3, coupling=0.2)
    Ht = pt.problems.fd_vector_laplacian_2d(12, b=3, coupling=0.2)
    x_star = np.random.default_rng(8).random(Hj.shape[0])
    b = Hj.matvec(x_star)
    Aj = pst.BdiaMatrix.from_host_csr(Hj, 3)
    At = pt.BdiaMatrix.from_host_csr(Ht, 3, device="cpu")
    before = spmv.bdia_spmv_launches
    st = pt.solve(At, b, tau=1e-10, method=method, precond=precond)
    sj = pst.solve(Aj, b, tau=1e-10, method=method, precond=precond)
    assert st.success and spmv.bdia_spmv_launches == before
    _agree(st, sj)
    assert _rel(st.soln.numpy(), x_star) <= 1e-6
    if method == "gmres":
        with pytest.raises(ValueError, match='method="cg"'):
            pt.solve(At, np.stack([b, b], 1), method="gmres")
