"""ILU(t)/IC(t) of the port against the JAX package on the same seeded
inputs (f64): the factors bit-equal (both packages call the same native
library, and the Python fallbacks are one code), ``trisolve_jacobi`` and the
preconditioner applies within 1e-12 relative (the same sums in another
order), and the trisolve modes' rules.

At m >= 31 every multiplier of ILUT on the convection-diffusion stencil
falls under the h⁻²-scaled drop threshold, so L is the identity in both
packages (ROADMAP queue 3 records this reference-side rule); the factor
tests hold the port to it only as parity."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysolvers_tpu as pst
import pysolvers_tpu_torch as pt
from pysolvers_tpu.linear import ilu as jilu
from pysolvers_tpu.ops import trisolve as jtri
from pysolvers_tpu_torch.linear import ilu as tilu
from pysolvers_tpu_torch.ops import bws_spmv as tbws
from pysolvers_tpu_torch.ops import trisolve as ttri
from pysolvers_tpu_torch.utils import native as tnative

torch.set_num_threads(1)

PROBLEMS = {
    "convdiff": (pst.problems.laplacian.fd_convection_diffusion_2d,
                 pt.problems.fd_convection_diffusion_2d),
    "laplacian": (pst.problems.fd_laplacian_2d, pt.problems.fd_laplacian_2d),
}


def _pair(name, m):
    fj, ft = PROBLEMS[name]
    return fj(m), ft(m)


def _same_csr(a, b):
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    assert a.data.dtype == b.data.dtype
    np.testing.assert_array_equal(a.data, b.data)


def _rel(x, y):
    return float(np.linalg.norm(np.asarray(x) - np.asarray(y))
                 / np.linalg.norm(np.asarray(y)))


def test_convection_diffusion_is_the_jax_matrix():
    for m in (3, 15, 32):
        Hj, Ht = _pair("convdiff", m)
        _same_csr(Ht, Hj)


@pytest.mark.parametrize("m", [15, 31])
@pytest.mark.parametrize("drop_tol", [1e-4, 1e-2])
def test_ilut_factors_bit_equal(m, drop_tol):
    Hj, Ht = _pair("convdiff", m)
    Lj, Uj = jilu.ilut_factor(Hj, drop_tol, 15.0)
    Lt, Ut = tilu.ilut_factor(Ht, drop_tol, 15.0)
    _same_csr(Lt, Lj)
    _same_csr(Ut, Uj)


def test_ilut_python_fallback_bit_equal(monkeypatch):
    from pysolvers_tpu.utils import native as jnative
    Hj, Ht = _pair("convdiff", 9)
    monkeypatch.setattr(jnative, "ilut", lambda *a: None)
    monkeypatch.setattr(tnative, "ilut", lambda *a: None)
    for drop_tol in (1e-4, 3e-2):
        Lj, Uj = jilu.ilut_factor(Hj, drop_tol, 2.0)
        Lt, Ut = tilu.ilut_factor(Ht, drop_tol, 2.0)
        _same_csr(Lt, Lj)
        _same_csr(Ut, Uj)


@pytest.mark.parametrize("m", [12, 31])
def test_ict_factor_bit_equal(m):
    Hj, Ht = _pair("laplacian", m)
    _same_csr(tilu.ict_factor(Ht, 1e-4), jilu.ict_factor(Hj, 1e-4))


def test_ict_refuses_an_indefinite_matrix():
    H = pt.problems.fd_laplacian_2d(6)
    H.data = -H.data
    with pytest.raises(ValueError, match="positive definite"):
        tilu.ict_factor(H)


@pytest.mark.parametrize("drop_scale", ["auto", 1.0, 0.01])
@pytest.mark.parametrize("kind,name", [("ilut", "convdiff"),
                                       ("ic", "laplacian")])
def test_drop_scale_factor_matches_jax(kind, name, drop_scale):
    """The drop scale gives the JAX package's factor for the modes it
    shares with the port ("auto": the seed scale, one factorization)."""
    Hj, Ht = _pair(name, 15)
    T = (pt.ILUTPreconditionerType if kind == "ilut"
         else pt.ICPreconditionerType)
    Tj = (pst.ILUTPreconditionerType if kind == "ilut"
          else pst.ICPreconditionerType)
    ft = T(trisolve_mode="level", drop_scale=drop_scale)._factor(Ht)
    fj = Tj(trisolve_mode="level", drop_scale=drop_scale)._factor(Hj)
    for a, b in zip(ft if kind == "ilut" else [ft],
                    fj if kind == "ilut" else [fj]):
        _same_csr(a, b)


@pytest.mark.parametrize("plan_dtype", [np.float64, np.float32])
@pytest.mark.parametrize("lower", [True, False])
def test_trisolve_jacobi_matches_jax(plan_dtype, lower):
    Hj, Ht = _pair("convdiff", 15)
    Lj, Uj = jilu.ilut_factor(Hj, 1e-4)
    Tj = Lj if lower else Uj
    pj = jtri.build_trisolve_plan(Tj, lower=lower, unit_diag=lower,
                                  dtype=plan_dtype)
    pp = ttri.build_trisolve_plan(Tj, lower=lower, unit_diag=lower,
                                  dtype=plan_dtype, device="cpu")
    b = np.random.default_rng(0).standard_normal(Hj.shape[0])
    for sweeps in (1, 4, 10):
        yj = jtri.trisolve_jacobi(pj, jnp.asarray(b), sweeps)
        yt = ttri.trisolve_jacobi(pp, torch.from_numpy(b), sweeps)
        assert yt.dtype == torch.float64
        assert _rel(yt.numpy(), yj) <= 1e-12


def test_trisolve_jacobi_reaches_the_exact_solve():
    """Enough sweeps (the level count) give the level-scheduled solve."""
    H = pt.problems.fd_laplacian_2d(6)
    plan = ttri.build_trisolve_plan(H.extract_lower(), lower=True,
                                    device="cpu")
    b = torch.from_numpy(np.random.default_rng(1).random(36))
    exact = ttri.trisolve(plan, b)
    assert _rel(ttri.trisolve_jacobi(plan, b, 11).numpy(), exact) <= 1e-14


def _apply_pair(kind, mode, m, name):
    Hj, Ht = _pair(name, m)
    T = (pt.ILUTPreconditionerType if kind == "ilut"
         else pt.ICPreconditionerType)
    Tj = (pst.ILUTPreconditionerType if kind == "ilut"
          else pst.ICPreconditionerType)
    pj = Tj(trisolve_mode=mode).form(Hj)
    pp = T(trisolve_mode=mode).form(Ht, device="cpu")
    v = np.random.default_rng(3).standard_normal(Ht.shape[0])
    return (np.asarray(pj.apply_any(jnp.asarray(v))),
            pp.apply_any(torch.from_numpy(v)).numpy(), pp)


@pytest.mark.parametrize("kind,name", [("ilut", "convdiff"),
                                       ("ic", "laplacian")])
@pytest.mark.parametrize("mode", ["auto", "level", "jacobi"])
def test_factor_apply_matches_jax(kind, name, mode):
    yj, yt, pp = _apply_pair(kind, mode, 15, name)
    assert pp.right is not None and pp.left is None and not pp.generic
    assert _rel(yt, yj) <= 1e-12


def test_jacobi_bws_apply_matches_jax(monkeypatch):
    """Both factors pack at m = 15: the JAX package's Jacobi sweeps, with
    each of the 9 products per factor taken on the f32 BWS pack (K2's
    twin here, no K2 launch on the CPU; the twin is held to the JAX BWS
    kernel in test_torch_bws.py), so within f32 rounding of the f64
    sweeps."""
    calls = []
    real = tilu.bws_spmv
    monkeypatch.setattr(tilu, "bws_spmv",
                        lambda N, x: calls.append(N) or real(N, x))
    before = tbws.bws_spmv_launches
    Hj, Ht = _pair("convdiff", 15)
    pj = pst.ILUTPreconditionerType(trisolve_mode="jacobi").form(Hj)
    pp = pt.ILUTPreconditionerType(trisolve_mode="jacobi_bws").form(
        Ht, device="cpu")
    v = np.random.default_rng(3).standard_normal(Ht.shape[0])
    yt = pp.apply_any(torch.from_numpy(v))
    assert len(calls) == 18 and yt.dtype == torch.float64
    assert _rel(yt.numpy(), pj.apply_any(jnp.asarray(v))) <= 1e-6
    assert tbws.bws_spmv_launches == before


def test_jacobi_bws_diagonal_factor_needs_no_product(monkeypatch):
    """A factor with no off-diagonal entry (ILUT's L here) is solved by its
    diagonal; U still runs its sweeps through the BWS pack."""
    H = pt.problems.fd_convection_diffusion_2d(31)
    L, U = tilu.ilut_factor(H, 1e-4)
    assert L.nnz == H.shape[0]
    calls = []
    real = tilu.bws_spmv
    monkeypatch.setattr(tilu, "bws_spmv",
                        lambda N, x: calls.append(N) or real(N, x))
    sl = tilu._bws_sweep_solver(L, True, 10, np.float32, "cpu")
    su = tilu._bws_sweep_solver(U, False, 10, np.float32, "cpu")
    v = torch.from_numpy(np.random.default_rng(4).standard_normal(961))
    assert torch.equal(sl(v), v)
    y = su(v)
    assert len(calls) == 9
    plan = ttri.build_trisolve_plan(U, lower=False, device="cpu")
    assert _rel(y.numpy(), ttri.trisolve_jacobi(plan, v, 10)) <= 1e-6


def _unbanded(n=40_000):
    """tridiag(-1, 4, -1) with a coupling between the first and last
    unknowns: ILUT keeps l_{n-1,0}, so the strict L spans every column
    and does not pack as BWS."""
    rows = np.r_[np.arange(n), np.arange(1, n), np.arange(n - 1), 0, n - 1]
    cols = np.r_[np.arange(n), np.arange(n - 1), np.arange(1, n), n - 1, 0]
    vals = np.r_[np.full(n, 4.0), -np.ones(2 * (n - 1)), -1.0, -1.0]
    return pt.HostCSR.from_coo(rows, cols, vals, (n, n))


def test_jacobi_bws_unpackable_factor_degrades_on_cpu_only():
    """The CPU keeps the JAX package's degrade (the torch Jacobi sweeps);
    a card never does: the factor that fails is named, and the check runs
    on the host before anything is uploaded."""
    H = _unbanded()
    v = torch.from_numpy(np.random.default_rng(5).standard_normal(
        H.shape[0]))
    T = pt.ILUTPreconditionerType
    y = T(trisolve_mode="jacobi_bws").form(H, device="cpu").apply_any(v)
    ref = T(trisolve_mode="jacobi").form(H, device="cpu").apply_any(v)
    assert torch.equal(y, ref)
    with pytest.raises(ValueError, match="the lower factor does not pack"):
        T(trisolve_mode="jacobi_bws").form(H, device="cuda")


def test_jacobi_bws_zero_pivot_raises_off_the_cpu():
    H = pt.problems.fd_laplacian_2d(6)
    U = H.extract_upper()
    U.data[U.indptr[3]] = 0.0              # row 3's diagonal
    L = pt.HostCSR.from_coo(np.arange(36), np.arange(36), np.ones(36),
                            (36, 36))
    with pytest.raises(ValueError, match="the lower factor has a zero "
                                         "pivot in row 3"):
        tilu._factor_apply(U.transpose(), U, False, "jacobi_bws", 10,
                           np.float64, torch.device("cuda"))
    # the CPU degrades to the torch sweeps, whose plan refuses the pivot
    with pytest.raises(ZeroDivisionError, match="zero diagonal"):
        tilu._factor_apply(L, U, True, "jacobi_bws", 10, np.float64, "cpu")


def test_fill_guard_raises():
    H = pt.problems.fd_convection_diffusion_2d(8)
    L, U = tilu.ilut_factor(H, 1e-4)
    with pytest.raises(RuntimeError, match="fill exploded"):
        tilu._check_fill(H, L, U, 0.01, "ILUT")


def test_aliases():
    assert pt.RightILUT is pt.ILUTPreconditionerType
    assert pt.RightIC is pt.ICPreconditionerType
    left = pt.LeftILUT(1e-3, 15)
    assert left.side == "left" and left.drop_tol == 1e-3
