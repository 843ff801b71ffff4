"""The exact block-banded triangular solve (``ops/block_trisolve.py``) and
the ILU(t)/IC(t) "block" mode of the port against the JAX package on the
same seeded inputs.

The JAX package runs its block path on the CPU (as its own
``tests/test_block_trisolve.py`` does): the plans are built by its XLA
setup and solved by its ``lax.scan``.  Tolerances, relative to max|x|:
the twin within 1e-12 of JAX's solve in f64 and 1e-5 in f32, and the plans'
``s_hat``/``dinv`` within 1e-12 in f64 (the same dense products summed in
another order; the factors here are well conditioned, so the recurrence
does not amplify those roundings).  The fill-budget search of
``drop_scale="auto"`` gives JAX's scale and bit-equal factors (both call
the same native ILUT), and the block-mode solves JAX's iteration counts
within 1."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysolvers_tpu as pst
import pysolvers_tpu_torch as pt
from pysolvers_tpu.linear import ilu as jilu
from pysolvers_tpu.ops import block_trisolve as jbt
from pysolvers_tpu.problems.fem import fem_poisson_2d_unstructured
from pysolvers_tpu.sparse.bws import BwsMatrix as JBwsMatrix
from pysolvers_tpu_torch.linear import ilu as tilu
from pysolvers_tpu_torch.ops import block_trisolve as tbt
from pysolvers_tpu_torch.ops import trisolve as ttri

torch.set_num_threads(1)

TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _rel(x, y):
    x, y = np.asarray(x, dtype=np.float64), np.asarray(y, dtype=np.float64)
    return float(np.abs(x - y).max() / np.abs(y).max())


def _factor(name):
    """(factor, lower, unit diagonal) of one case: ILUT of the
    convection-diffusion operator at m = 15 (L keeps 420 multipliers
    there), IC of the 5-point Laplacian at m = 20, and IC/ILUT of the
    RCM-ordered unstructured FEM matrix; n = 225, 400 and 576, none a
    multiple of the block sizes."""
    if name.startswith("convdiff"):
        L, U = jilu.ilut_factor(
            pst.problems.laplacian.fd_convection_diffusion_2d(15), 1e-4)
        return (L, True, True) if name.endswith("L") else (U, False, False)
    if name.startswith("laplacian"):
        Lc = jilu.ict_factor(pst.problems.fd_laplacian_2d(20), 1e-4)
        return (Lc, True, False) if name.endswith("L") else (
            Lc.transpose(), False, False)
    H = fem_poisson_2d_unstructured(25, seed=3)
    Hp = H.permute_symmetric(JBwsMatrix._rcm_perm(H))
    if name == "fem_rcm_ic_L":
        return jilu.ict_factor(Hp, 1e-4), True, False
    return jilu.ilut_factor(Hp, 1e-4)[1], False, False


FACTORS = ["convdiff_ilut_L", "convdiff_ilut_U", "laplacian_ic_L",
           "laplacian_ic_Lt", "fem_rcm_ic_L", "fem_rcm_ilut_U"]
CASES = ([(f, bs, np.float64) for f in FACTORS for bs in (64, 128, 256)]
         + [(f, 64, np.float32) for f in FACTORS])


@pytest.mark.parametrize("name,bs,dtype", CASES)
def test_twin_matches_jax(name, bs, dtype):
    """Plans and solves of lower and upper, unit and non-unit factors at
    three block sizes (p = 0 for ILUT at bs = 256, where n < bs)."""
    T, lower, unit = _factor(name)
    n = T.shape[0]
    pj = jbt.build_block_trisolve_plan(T, lower, unit, bs=bs, dtype=dtype)
    pp = tbt.build_block_trisolve_plan(T, lower, unit, bs=bs, dtype=dtype,
                                       device="cpu")
    assert (pp.n, pp.bs, pp.p, pp.nb, pp.flip) == (pj.n, pj.bs, pj.p, pj.nb,
                                                   pj.flip)
    assert pp.dtype == getattr(torch, np.dtype(dtype).name)
    if dtype == np.float64:
        assert _rel(pp.dinv.numpy(), pj.dinv) <= 1e-12
        if pp.p:
            assert _rel(pp.s_hat.numpy(), pj.s_hat) <= 1e-12
    b = np.random.default_rng(0).standard_normal(n)
    xj = np.asarray(jbt.block_trisolve(pj, jnp.asarray(b)))
    before = tbt.block_trisolve_launches
    xt = tbt.block_trisolve(pp, torch.from_numpy(b))
    assert xt.dtype == torch.float64 and tbt.block_trisolve_launches == before
    assert _rel(xt.numpy(), xj) <= TOL[dtype]


def test_twin_is_the_exact_solve():
    """p = 2 at bs = 32 on the block lane's node-major IC factor: the twin
    solves the factor, as the level-scheduled solve does."""
    H = pt.problems.fd_vector_laplacian_2d(12, b=5, coupling=0.2)
    Lc = tilu.ict_factor(H, 1e-4)
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(720))
    for T, lower in ((Lc, True), (Lc.transpose(), False)):
        plan = tbt.build_block_trisolve_plan(T, lower, bs=32,
                                             dtype=np.float64, device="cpu")
        assert plan.p == 2
        ref = ttri.trisolve(ttri.build_trisolve_plan(T, lower, device="cpu"),
                            b)
        assert _rel(tbt.block_trisolve(plan, b).numpy(), ref.numpy()) <= 1e-12


def _arrow(n=1024):
    rows = np.concatenate([np.arange(n), np.full(n - 1, n - 1)])
    cols = np.concatenate([np.arange(n), np.arange(n - 1)])
    vals = np.concatenate([np.full(n, 2.0), np.full(n - 1, 0.1)])
    return pt.HostCSR.from_coo(rows, cols, vals, (n, n))


def test_refusals():
    """Block reach above max_p, dense blocks above max_bytes, an entry
    above the diagonal inside a diagonal block, a wide array past int32
    indices: each a ValueError on the host."""
    build = tbt.build_block_trisolve_plan
    with pytest.raises(ValueError, match="exceeds max_p=4"):
        build(_arrow(), lower=True, bs=64, device="cpu")
    with pytest.raises(ValueError, match="max_bytes"):
        build(_arrow(), lower=True, bs=64, max_p=100, max_bytes=1 << 20,
              device="cpu")
    rows = np.concatenate([np.arange(8), [1]])
    cols = np.concatenate([np.arange(8), [2]])
    T = pt.HostCSR.from_coo(rows, cols, np.r_[np.full(8, 2.0), 0.5], (8, 8),
                            sum_duplicates=False)
    with pytest.raises(ValueError, match="triangular"):
        build(T, lower=True, bs=4, device="cpu")
    with pytest.raises(ValueError, match="triangular"):
        tbt.build_block_trisolve_plan_pair(T, T.transpose(), bs=4,
                                           device="cpu")
    one = np.zeros(1, dtype=np.int64)
    with pytest.raises(ValueError, match="int32"):
        tbt._prep(one, one, np.ones(1), 1, 2 ** 20, 256, 4)


def test_wrapper_checks_its_arguments():
    T, lower, unit = _factor("convdiff_ilut_U")
    plan = tbt.build_block_trisolve_plan(T, lower, bs=64, dtype=np.float64,
                                         device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tbt.block_trisolve(plan, torch.zeros(10, dtype=torch.float64))
    with pytest.raises(ValueError, match="is on"):
        tbt.block_trisolve(plan, torch.zeros(225, device="meta"))


@pytest.mark.parametrize("kind", ["ilut", "ic"])
def test_drop_scale_search_matches_jax(kind, monkeypatch):
    """The fill-budget search of "auto" in block mode: the JAX package's
    resolved scale (here well below the seed) and its factors bit for
    bit."""
    H = pst.problems.laplacian.fd_convection_diffusion_2d(15)
    Tj = (pst.ILUTPreconditionerType if kind == "ilut"
          else pst.ICPreconditionerType)
    Tt = (pt.ILUTPreconditionerType if kind == "ilut"
          else pt.ICPreconditionerType)
    jilu._SCALE_CACHE.clear()
    tilu._SCALE_CACHE.clear()
    fj = Tj(trisolve_mode="block")._factor(H)
    ft = Tt(trisolve_mode="block")._factor(H, "cpu")
    (kj, sj), = jilu._SCALE_CACHE.items()
    (kt, st), = tilu._SCALE_CACHE.items()
    assert kt == kj and st == sj and sj < tilu._AUTO_SEED / 4
    for a, b in zip(ft if kind == "ilut" else [ft],
                    fj if kind == "ilut" else [fj]):
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.data, b.data)
    # warm: the cached scale, one factorization, the same factors
    calls = []
    real = tilu.ilut_factor
    monkeypatch.setattr(tilu, "ilut_factor",
                        lambda A, drop_tol, fill_factor: calls.append(
                            drop_tol) or real(A, drop_tol, fill_factor))
    Tt(trisolve_mode="block")._factor(H, "cpu")
    assert calls == [1e-3 * st]


def test_scale_cache_is_bounded():
    tilu._SCALE_CACHE.clear()
    for m in range(6, 6 + 70):
        H = pt.problems.fd_laplacian_2d(m)
        tilu._resolve_drop_scale("ic", H, 1e-3, 15.0, "auto",
                                 lambda eff: (None, 10 ** 9))
    assert len(tilu._SCALE_CACHE) == 65


def _solve_pair(kind, m):
    """The port's and the JAX package's block-mode solves of one seeded
    system: PCG + IC(t) on the 5-point Laplacian, GMRES + ILUT on the
    convection-diffusion operator (f64, tau = 1e-10)."""
    if kind == "ic":
        Hj = pst.problems.fd_laplacian_2d(m)
        Ht = pt.problems.fd_laplacian_2d(m)
    else:
        Hj = pst.problems.laplacian.fd_convection_diffusion_2d(m)
        Ht = pt.problems.fd_convection_diffusion_2d(m)
    b = Ht.matvec(np.random.default_rng(2).random(Ht.shape[0]))
    args = dict(maxiter=500, tau=1e-10)
    Pj = pst.ICPreconditionerType if kind == "ic" else pst.ILUTPreconditionerType
    Pt = pt.ICPreconditionerType if kind == "ic" else pt.ILUTPreconditionerType
    Sj = pst.PCG if kind == "ic" else pst.GMRES
    St = pt.PCG if kind == "ic" else pt.GMRES
    jilu._SCALE_CACHE.clear()
    tilu._SCALE_CACHE.clear()
    sj = Sj(pst.CommonSolverArgs(**args), precond=Pj(trisolve_mode="block")
            ).make_solver().solve(Hj, b)
    solver = St(pt.CommonSolverArgs(**args), precond=Pt(trisolve_mode="block"),
                device="cpu").make_solver()
    st = solver.solve(Ht, b)
    return st, sj, solver


@pytest.mark.parametrize("kind,m", [("ic", 15), ("ilut", 15), ("ilut", 31)])
def test_block_mode_iterations_match_jax(kind, m):
    st, sj, solver = _solve_pair(kind, m)
    assert st.success and sj.success and st.reason == sj.reason
    assert abs(st.iters - sj.iters) <= 1
    xj = np.asarray(sj.soln)
    assert np.linalg.norm(st.soln.numpy() - xj) / np.linalg.norm(xj) <= 1e-8
    plans = solver._formed_prec.state
    assert all(isinstance(p, tbt.BlockTriSolvePlan) for p in plans)
    assert [p.flip for p in plans] == [False, True]


def test_auto_is_level_on_the_cpu_and_block_on_cuda(monkeypatch):
    """On the CPU "auto" stays "level": no block plan, and one
    factorization at the seed scale, no search."""
    assert tilu._resolve_trisolve_mode("auto", "cpu") == "level"
    assert tilu._resolve_trisolve_mode("auto", "cuda") == "block"
    assert tilu._resolve_trisolve_mode("block", "cpu") == "block"

    def boom(*a, **k):
        raise AssertionError("block plan on the CPU")
    monkeypatch.setattr(tilu, "build_block_trisolve_plan_pair", boom)
    tilu._SCALE_CACHE.clear()
    H = pt.fd_convection_diffusion_2d(15)
    prec = pt.ILUTPreconditionerType().form(H, device="cpu")
    assert prec.state is None and not tilu._SCALE_CACHE
    v = torch.from_numpy(np.random.default_rng(3).standard_normal(225))
    ref = pt.ILUTPreconditionerType(trisolve_mode="level").form(
        H, device="cpu")
    assert torch.equal(prec.apply_any(v), ref.apply_any(v))


@pytest.mark.parametrize("T", [pt.ILUTPreconditionerType,
                               pt.ICPreconditionerType])
def test_unknown_trisolve_mode_raises(T):
    with pytest.raises(ValueError, match="trisolve_mode"):
        T(trisolve_mode="levels")
    T(trisolve_mode="block")


def _unbanded(n):
    """tridiag(-1, 4, -1) with the first and last unknowns coupled: the
    factors' block reach is nb - 1, and the strict L does not pack as
    BWS."""
    rows = np.r_[np.arange(n), np.arange(1, n), np.arange(n - 1), 0, n - 1]
    cols = np.r_[np.arange(n), np.arange(n - 1), np.arange(1, n), n - 1, 0]
    vals = np.r_[np.full(n, 4.0), -np.ones(2 * (n - 1)), -1.0, -1.0]
    return pt.HostCSR.from_coo(rows, cols, vals, (n, n))


def _auto_is_block(monkeypatch):
    """Resolve "auto" as on a CUDA device while running on the CPU."""
    real = tilu._resolve_trisolve_mode
    monkeypatch.setattr(tilu, "_resolve_trisolve_mode",
                        lambda mode, device=None: "block" if mode == "auto"
                        else real(mode, device))


@pytest.mark.parametrize("T", [pt.ILUTPreconditionerType,
                               pt.ICPreconditionerType])
def test_explicit_block_degrades_to_level(T):
    H = _unbanded(2_000)                  # block reach 7
    v = torch.from_numpy(np.random.default_rng(5).standard_normal(2_000))
    with pytest.warns(UserWarning, match="exact level-scheduled"):
        prec = T(trisolve_mode="block", drop_scale=0.1).form(H, device="cpu")
    ref = T(trisolve_mode="level", drop_scale=0.1).form(H, device="cpu")
    assert torch.equal(prec.apply_any(v), ref.apply_any(v))


def test_auto_degrades_to_bws_sweeps_then_jacobi(monkeypatch):
    """"auto" where it means "block": a factor too wide for the block
    path takes the K2 sweeps, with a warning; one that does not pack
    either takes the Jacobi sweeps on the CPU, as an explicit "jacobi_bws"
    does there (the card raises instead)."""
    _auto_is_block(monkeypatch)
    H = _unbanded(40_000)                 # wide enough not to pack
    v = torch.from_numpy(np.random.default_rng(5).standard_normal(40_000))
    with pytest.warns(UserWarning,
                      match="degrading to approximate Jacobi/BWS sweeps"):
        prec = pt.ILUTPreconditionerType(drop_scale=0.1).form(H, device="cpu")
    ref = pt.ILUTPreconditionerType(trisolve_mode="jacobi",
                                    drop_scale=0.1).form(H, device="cpu")
    assert torch.equal(prec.apply_any(v), ref.apply_any(v))


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_block_miss_by_mode_and_device(device):
    """Where the block path does not apply, "auto" takes the K2 sweeps on
    any device; an explicit "block" takes the level solves on the CPU and
    raises on the card, naming the modes to pass.  (The fallback reads
    only the device's type, so no card is needed.)"""
    dev = torch.device(device)
    with pytest.warns(UserWarning, match="Jacobi/BWS sweeps"):
        assert tilu._degrade_from_block("auto", "ILUT", dev) == "jacobi_bws"
    if device == "cpu":
        with pytest.warns(UserWarning, match="exact level-scheduled"):
            assert tilu._degrade_from_block("block", "IC", dev) == "level"
    else:
        with pytest.raises(ValueError, match="IC: factor not banded enough"
                           ".*trisolve_mode='level'"):
            tilu._degrade_from_block("block", "IC", dev)


def test_auto_degrades_to_bws_sweeps(monkeypatch):
    """A factor that packs keeps the K2 sweeps (their twin here)."""
    _auto_is_block(monkeypatch)
    monkeypatch.setattr(tilu, "_block_plan_pair", lambda *a: None)
    H = pt.fd_convection_diffusion_2d(15)
    v = torch.from_numpy(np.random.default_rng(6).standard_normal(225))
    with pytest.warns(UserWarning, match="Jacobi/BWS sweeps"):
        prec = pt.ICPreconditionerType(drop_scale=0.1).form(H, device="cpu")
    ref = pt.ICPreconditionerType(trisolve_mode="jacobi_bws",
                                  drop_scale=0.1).form(H, device="cpu")
    assert torch.equal(prec.apply_any(v), ref.apply_any(v))


def test_block_lane_ic_plans_are_f64(monkeypatch):
    """The block lane's IC factors in f32 as the JAX package does, and its
    block plans are built from that factor in the operator's f64, so the
    apply is the level solves' exact one (they promote)."""
    # the package exports the function solve(), which hides the module
    tsolve = importlib.import_module("pysolvers_tpu_torch.solve")
    H = pt.problems.fd_vector_laplacian_2d(12, b=5, coupling=0.2)
    A = pt.BdiaMatrix.from_host_csr(H, 5, device="cpu")
    v = torch.from_numpy(np.random.default_rng(7).standard_normal(720))
    _auto_is_block(monkeypatch)
    seen = []
    real = tilu.build_block_trisolve_plan_pair
    monkeypatch.setattr(tilu, "build_block_trisolve_plan_pair",
                        lambda *a, **k: seen.append(k["dtype"]) or real(*a, **k))
    tilu._SCALE_CACHE.clear()
    block = tsolve._bdia_ic_form(A).apply_any(v)
    assert seen == [np.float64] and block.dtype == torch.float64
    # the level solves of the same f32 factor (at the scale the search
    # resolved), promoted to f64
    scale, = tilu._SCALE_CACHE.values()
    Hn = A.to_host_csr()
    level = pt.ICPreconditionerType(trisolve_mode="level", drop_scale=scale
                                    ).form(pt.HostCSR(
                                        Hn.indptr, Hn.indices,
                                        Hn.data.astype(np.float32), Hn.shape),
                                        device="cpu")
    ref = A.to_planar(level.apply_any(A.from_planar(v)))
    assert _rel(block, ref) <= 1e-12


def test_block_lane_gmres_ic_matches_jax(monkeypatch):
    """The block lane's GMRES + IC in block mode: the port's f64 plans keep
    the apply exact, so it converges; the JAX package's f32 plans stop it
    with a true-residual mismatch at the same iteration.  The two
    solutions agree to the f32 apply's rounding."""
    _auto_is_block(monkeypatch)
    real = jilu._resolve_trisolve_mode
    monkeypatch.setattr(jilu, "_resolve_trisolve_mode",
                        lambda mode: "block" if mode == "auto" else real(mode))
    Hj = pst.problems.laplacian.fd_vector_laplacian_2d(32, b=5,
                                                       coupling=0.2)
    Ht = pt.problems.fd_vector_laplacian_2d(32, b=5, coupling=0.2)
    b = Ht.matvec(np.random.default_rng(5).random(Ht.shape[0]))
    jilu._SCALE_CACHE.clear()
    tilu._SCALE_CACHE.clear()
    sj = pst.solve(pst.BdiaMatrix.from_host_csr(Hj, 5), b, tau=1e-10,
                   method="gmres", precond="ic")
    At = pt.BdiaMatrix.from_host_csr(Ht, 5, device="cpu")
    st = pt.solve(At, b, tau=1e-10, method="gmres", precond="ic")
    assert st.success and sj.reason.name == "TRUE_RESID_MISMATCH"
    assert abs(st.iters - sj.iters) <= 1
    x = st.soln.numpy()
    assert np.linalg.norm(b - Ht.matvec(x)) <= 1e-10 * np.linalg.norm(b)
    xj = np.asarray(sj.soln)
    assert np.linalg.norm(x - xj) / np.linalg.norm(xj) <= 1e-5


def _dinv_factor(name):
    if name in ("ilut_L", "ilut_U"):
        L, U = tilu.ilut_factor(pt.fd_convection_diffusion_2d(15), 1e-4)
        return (L, True, True) if name == "ilut_L" else (U, False, False)
    Lc = tilu.ict_factor(pt.problems.fd_laplacian_2d(20), 1e-4)
    return (Lc, True, False) if name == "ic_L" else (Lc.transpose(), False,
                                                     False)


@pytest.mark.parametrize("name", ["ilut_L", "ilut_U", "ic_L", "ic_Lt"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dinv_is_exactly_lower_triangular(name, dtype):
    """K8's stage 1 reads row r of dinv_i up to column r only: the plans
    hold exact zeros above the diagonal, at block sizes that do and do not
    divide n, so that reading the triangle computes dinv_i b_i."""
    T, lower, unit = _dinv_factor(name)
    for bs in (16, 63, 64, 256):
        plan = tbt.build_block_trisolve_plan(T, lower, unit, bs=bs,
                                             dtype=dtype, device="cpu")
        assert bool((torch.triu(plan.dinv, 1) == 0).all())
        b = torch.from_numpy(np.random.default_rng(0).standard_normal(
            plan.nb * bs)).to(plan.dtype).view(plan.nb, bs, 1)
        tri = torch.tril(plan.dinv)
        assert torch.equal(torch.bmm(tri, b), torch.bmm(plan.dinv, b))
