"""The port's device-built SA hierarchy (``build_sa_hierarchy_device``,
``parallel/amg_setup.py``) against the JAX package's on the CPU.

Tolerances, relative to max|·| of the JAX value: 1e-12 in f64 and 1e-5 in
f32 for P, R, A_c per level and A0_inv (the products are the same
formulas; they differ by the summation order of the sparse and dense
products and of the inverse, which the port takes in f64 and rounds once
in f32), and for one V-cycle's output.  Iteration counts are equal.

The port stores P, R and the level operators sparse (their exact
nonzeros) where the JAX package stores them dense, and keeps only
A0_inv at the coarsest level; the tests densify what they compare."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysolvers_tpu as pst
import pysolvers_tpu.linear.amg as jamg
import pysolvers_tpu.sparse.device as jdev
import pysolvers_tpu_torch as pt
import pysolvers_tpu_torch.linear.amg as tamg
from pysolvers_tpu_torch import convert
from pysolvers_tpu_torch.parallel import amg_setup
from pysolvers_tpu_torch.sparse import bws as tbws
from pysolvers_tpu_torch.sparse.bws import BwsCsrMatrix, pack_fits
from pysolvers_tpu_torch.utils.timing import Timer

torch.set_num_threads(1)

TOL = {np.float64: 1e-12, np.float32: 1e-5}
PROBLEMS = {"fem20": lambda: pt.problems.fem_poisson_2d_unstructured(
                20, seed=3),
            "fd24": lambda: pt.problems.fd_laplacian_2d(24)}
CASES = [(p, levels, dtype) for p in PROBLEMS for levels in (2, 3)
         for dtype in (np.float64, np.float32)]
IDS = [f"{p}-L{levels}-{np.dtype(d).name}" for p, levels, d in CASES]


def _pair(name, dtype=np.float64):
    """The same matrix in both packages, in ``dtype``."""
    H = PROBLEMS[name]()
    data = H.data.astype(dtype)
    return (pst.HostCSR(H.indptr, H.indices, data, H.shape),
            pt.HostCSR(H.indptr, H.indices, data, H.shape))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _np(x):
    """A port operator (dense, DIA or ELL) or a JAX array as a dense
    numpy array."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, (pt.DiaMatrix, pt.EllMatrix)):
        return pt.matmat(x, torch.eye(x.shape[1], dtype=x.dtype)).numpy()
    return np.asarray(x)


def _device_built(monkeypatch):
    """Count the device setup's builds (its products' timer)."""
    calls = []
    real = amg_setup._setup_products
    monkeypatch.setattr(amg_setup, "_setup_products",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


@functools.lru_cache(maxsize=None)
def _built(name, levels, dtype):
    Hj, Ht = _pair(name, dtype)
    hj = jamg.build_sa_hierarchy_device(Hj, num_levels=levels, dtype=dtype)
    ht = tamg.build_sa_hierarchy_device(Ht, num_levels=levels, dtype=dtype,
                                        device="cpu")
    return hj, ht


@pytest.mark.parametrize("name,levels,dtype", CASES, ids=IDS)
def test_products_match_jax(name, levels, dtype):
    hj, ht = _built(name, levels, dtype)
    assert ht.n_levels == len(hj.levels) == levels
    assert ht.smoother == hj.smoother == "jacobi"
    tdtype = torch.from_numpy(np.zeros(0, dtype)).dtype
    # the coarsest level keeps only A0_inv in the port
    assert ht.levels[0].A_dev is None and ht.levels[0].dinv is None
    for k, (lj, lt) in enumerate(zip(hj.levels[1:], ht.levels[1:]), 1):
        for field in ("P_dev", "R_dev", "dinv"):
            a, b = getattr(lt, field), getattr(lj, field)
            assert a.dtype == tdtype, (k, field)
            assert not isinstance(a, torch.Tensor) or field == "dinv"
            assert _rel(_np(a), b) <= TOL[dtype], (k, field)
        if k < levels - 1:
            # A_c of the levels between: sparse in the port, dense in JAX
            assert isinstance(lt.A_dev, (pt.DiaMatrix, pt.EllMatrix))
            assert _rel(_np(lt.A_dev), lj.A_dev) <= TOL[dtype], k
    assert ht.A0_inv.dtype == tdtype
    assert _rel(ht.A0_inv.numpy(), hj.A0_inv) <= TOL[dtype]
    # R = Pᵀ, unnormalised, as in the JAX package
    for lt in ht.levels[1:]:
        assert np.array_equal(_np(lt.R_dev), _np(lt.P_dev).T)


@pytest.mark.parametrize("name,levels,dtype", CASES, ids=IDS)
def test_v_cycle_matches_jax(name, levels, dtype):
    hj, ht = _built(name, levels, dtype)
    n = ht.levels[-1].dinv.shape[0]
    f = np.random.default_rng(1).standard_normal(n).astype(dtype)
    y_ref = np.asarray(jamg.v_cycle(hj, jnp.asarray(f), jnp.zeros(n, dtype)))
    f_t = torch.from_numpy(f)
    y = tamg.v_cycle(ht, f_t, torch.zeros_like(f_t))
    assert _rel(y.numpy(), y_ref) <= TOL[dtype]


def _rhs(H):
    return H.matvec(np.random.default_rng(2).random(H.shape[0]))


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_pcg_amg_device_iterations_equal_jax(name):
    Hj, Ht = _pair(name)
    b = _rhs(Ht)
    cfg = dict(maxiter=200, tau=1e-10)
    sj = pst.PCG(pst.CommonSolverArgs(**cfg), precond=pst.AMG(
        num_iters=2, num_levels=3, galerkin="device")).make_solver().solve(
            Hj, b)
    st = pt.PCG(pt.CommonSolverArgs(**cfg), precond=pt.AMG(
        num_iters=2, num_levels=3, galerkin="device"),
        device="cpu").make_solver().solve(Ht, b)
    assert sj.success and st.success
    assert st.iters == sj.iters
    assert np.linalg.norm(Ht.matvec(st.soln.numpy()) - b) <= \
        1e-9 * np.linalg.norm(b)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_vcycle_solver_device_iterations_equal_jax(name):
    Hj, Ht = _pair(name)
    b = _rhs(Ht)
    cfg = dict(maxiter=300, tau=1e-10)
    sj = pst.AMGVCycle(pst.CommonSolverArgs(**cfg), num_levels=2,
                       galerkin="device").make_solver().solve(Hj, b)
    st = pt.AMGVCycle(pt.CommonSolverArgs(**cfg), num_levels=2,
                      galerkin="device", device="cpu").make_solver().solve(
        Ht, b)
    assert sj.success and st.success
    assert st.iters == sj.iters
    assert st.soln.dtype == torch.float64


@pytest.fixture
def small_gate(monkeypatch):
    """Both packages' device build functions with max_bytes = 1024; the
    port's "auto" rule set to build on the device, as on CUDA."""
    monkeypatch.setattr(jamg, "build_sa_hierarchy_device", functools.partial(
        jamg.build_sa_hierarchy_device, max_bytes=1024))
    monkeypatch.setattr(tamg, "build_sa_hierarchy_device", functools.partial(
        tamg.build_sa_hierarchy_device, max_bytes=1024))
    monkeypatch.setattr(tamg, "_device_galerkin", lambda device: True)


def test_gate_device_raises_in_both(small_gate):
    Hj, Ht = _pair("fd24")
    with pytest.raises(ValueError, match="max_bytes"):
        pst.AMG(galerkin="device").form(Hj)
    with pytest.raises(ValueError, match="max_bytes"):
        pt.AMG(galerkin="device").form(Ht, device="cpu")
    with pytest.raises(ValueError, match="max_bytes"):
        pt.AMGVCycle(galerkin="auto", device="cpu").make_solver().solve(
            Ht, _rhs(Ht))


def test_gate_auto_falls_back_to_the_host_build(small_gate, monkeypatch):
    """Over the gate "auto" builds on the host, in both packages (the JAX
    package's "auto" tries the device only on its accelerator, so its
    explicit "host" is the reference), and the preconditioners agree."""
    Hj, Ht = _pair("fd24")
    v = np.random.default_rng(3).standard_normal(Ht.shape[0])
    handed = []
    real = tamg.build_sa_hierarchy
    monkeypatch.setattr(tamg, "build_sa_hierarchy", lambda *a, **k: (
        handed.append(k.get("level0")) or real(*a, **k)))
    p_auto = pt.AMG(galerkin="auto", smoother="jacobi").form(Ht,
                                                             device="cpu")
    p_host = pt.AMG(galerkin="host", smoother="jacobi").form(Ht,
                                                             device="cpu")
    # the refused device build handed its finest aggregates over
    assert handed[0] is not None and handed[1] is None
    assert isinstance(p_auto.state.levels[-1].A_dev, pt.DiaMatrix)
    assert p_auto.state.levels[-1].P_dev is not None
    y = p_auto.apply_any(torch.from_numpy(v)).numpy()
    assert np.array_equal(y, p_host.apply_any(torch.from_numpy(v)).numpy())
    pj = pst.AMG(galerkin="host", smoother="jacobi").form(Hj)
    assert _rel(y, pj.apply_any(jnp.asarray(v))) <= 1e-12


@pytest.mark.parametrize("name", sorted(PROBLEMS))
@pytest.mark.parametrize("levels", [2, 3])
def test_handed_aggregates_give_the_fresh_host_build(name, levels):
    """The host build from the finest level's (strength, aggregates) that
    a refused device build formed equals a fresh host build bit for bit."""
    _, Ht = _pair(name)
    with pytest.raises(amg_setup.DenseGateError) as e:
        tamg.build_sa_hierarchy_device(Ht, levels, dtype=np.float64,
                                       max_bytes=1024, device="cpu")
    assert e.value.level0 is not None
    handed = tamg.build_sa_hierarchy(Ht, levels, level0=e.value.level0)
    fresh = tamg.build_sa_hierarchy(Ht, levels)
    for mats in ("matrices", "prolongators", "restrictions"):
        for a, b in zip(getattr(handed, mats), getattr(fresh, mats)):
            for f in ("indptr", "indices", "data"):
                assert np.array_equal(getattr(a, f), getattr(b, f))
            assert a.shape == b.shape
        assert len(getattr(handed, mats)) == len(getattr(fresh, mats))


@pytest.mark.parametrize("smoother", ["gs", "sgs"])
def test_auto_takes_the_host_build_for_gauss_seidel(smoother, monkeypatch):
    """The device build provides Jacobi and Chebyshev only: under the
    card's "auto" rule a GS or SGS smoother builds on the host, and the
    preconditioner is the explicit host build's."""
    monkeypatch.setattr(tamg, "_device_galerkin", lambda device: True)
    calls = _device_built(monkeypatch)
    _, Ht = _pair("fem20")
    v = torch.from_numpy(np.random.default_rng(7).standard_normal(
        Ht.shape[0]))
    p = pt.AMG(num_iters=2, smoother=smoother).form(Ht, device="cpu")
    ref = pt.AMG(num_iters=2, smoother=smoother, galerkin="host").form(
        Ht, device="cpu")
    assert calls == []
    assert torch.equal(p.apply_any(v), ref.apply_any(v))
    st = pt.PCG(pt.CommonSolverArgs(maxiter=200, tau=1e-10),
                precond=pt.AMG(num_iters=2, smoother=smoother),
                device="cpu").make_solver().solve(Ht, _rhs(Ht))
    assert st.success
    sv = pt.AMGVCycle(pt.CommonSolverArgs(maxiter=300, tau=1e-10),
                      smoother=smoother, galerkin="auto",
                      device="cpu").make_solver()
    assert sv.solve(Ht, _rhs(Ht)).success and calls == []


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_gs_smoother_raises(pkg):
    Hj, Ht = _pair("fd24")
    with pytest.raises(ValueError, match="jacobi/chebyshev"):
        if pkg == "jax":
            jamg.build_sa_hierarchy_device(Hj, smoother="gs",
                                           dtype=np.float64)
        else:
            tamg.build_sa_hierarchy_device(Ht, smoother="gs",
                                           dtype=np.float64, device="cpu")


def test_sgs_smoother_raises_under_explicit_device():
    _, Ht = _pair("fd24")
    with pytest.raises(ValueError, match="jacobi/chebyshev"):
        pt.AMG(galerkin="device", smoother="sgs").form(Ht, device="cpu")


@pytest.mark.parametrize("case", ["one_level", "stall"])
def test_single_level_matches_jax(case):
    if case == "one_level":
        Hj, Ht = _pair("fd24")
        levels = 1
    else:
        # n = 4 <= 8: the finest level is already the coarsest
        H = pt.problems.fd_laplacian_2d(2)
        Hj = pst.HostCSR(H.indptr, H.indices, H.data, H.shape)
        Ht, levels = H, 3
    hj = jamg.build_sa_hierarchy_device(Hj, num_levels=levels,
                                        dtype=np.float64)
    ht = tamg.build_sa_hierarchy_device(Ht, num_levels=levels,
                                        dtype=np.float64, device="cpu")
    assert ht.n_levels == len(hj.levels) == 1
    assert _rel(ht.A0_inv.numpy(), hj.A0_inv) <= 1e-12
    assert np.array_equal(ht.levels[0].A_dev.numpy(), Ht.to_dense())
    f = np.random.default_rng(4).standard_normal(Ht.shape[0])
    y = tamg.v_cycle(ht, torch.from_numpy(f), torch.zeros(len(f),
                                                          dtype=torch.float64))
    assert _rel(y.numpy(), np.linalg.solve(Ht.to_dense(), f)) <= 1e-12


def _op_arrays(op):
    if op is None:
        return None
    if isinstance(op, jax.Array):
        return np.asarray(op)
    if isinstance(op, jdev.DiaMatrix):
        return dict(diags=np.asarray(op.diags), offsets=op.offsets,
                    shape=op.shape)
    return dict(data=np.asarray(op.data), cols=np.asarray(op.cols),
                shape=op.shape, n_cols_pad=op.n_cols_pad)


@pytest.mark.parametrize("name,levels,dtype", CASES, ids=IDS)
def test_converted_jax_hierarchy_gives_the_ports_v_cycle(name, levels,
                                                        dtype):
    hj, ht = _built(name, levels, dtype)
    hc = convert.hierarchy_from_arrays(
        [dict(A=_op_arrays(L.A_dev), P=_op_arrays(L.P_dev),
              R=_op_arrays(L.R_dev), dinv=np.asarray(L.dinv), gs_plan=None,
              cheb=L.cheb) for L in hj.levels],
        np.asarray(hj.A0_inv), hj.smoother, hj.nu_pre, hj.nu_post,
        device="cpu")
    assert hc.levels[0].A_dev is None and hc.levels[0].dinv is None
    n = ht.levels[-1].dinv.shape[0]
    f = torch.from_numpy(np.random.default_rng(5).standard_normal(n)
                         .astype(dtype))
    y_c = tamg.v_cycle(hc, f, torch.zeros_like(f)).numpy()
    y_t = tamg.v_cycle(ht, f, torch.zeros_like(f)).numpy()
    assert _rel(y_c, y_t) <= TOL[dtype]


@pytest.mark.parametrize("name", sorted(PROBLEMS))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_chunked_products_are_bit_equal(name, dtype):
    """The sparse products in blocks of 7 and of 1 column equal the whole
    block: each column's terms are added in the same order."""
    _, Ht = _pair(name, dtype)
    from pysolvers_tpu_torch.linear.amg import (build_aggregates,
                                                filtered_matrix)
    agg = build_aggregates(Ht, 0.08)
    nc = int(agg.max()) + 1
    Af = filtered_matrix(Ht, 0.08)
    d = Af.diagonal()
    dinv = torch.from_numpy((1.0 / d).astype(dtype))
    A_dev = amg_setup._device_op(Ht, dtype, "cpu")
    Af_dev = amg_setup._device_op(Af, dtype, "cpu")
    agg_t = torch.from_numpy(agg.astype(np.int64))
    itemsize = np.dtype(dtype).itemsize
    with amg_setup._exact_matmuls():
        whole = amg_setup._setup_products(A_dev, Af_dev, dinv, agg_t, nc=nc,
                                          omega=2.0 / 3.0)
        for cols in (7, 1):
            parts = amg_setup._setup_products(
                A_dev, Af_dev, dinv, agg_t, nc=nc, omega=2.0 / 3.0,
                chunk_bytes=cols * Ht.shape[0] * itemsize)
            for a, b in zip(parts, whole):
                assert torch.equal(a, b)


def test_fine_format_on_the_cpu():
    """"auto" keeps the product operator on the CPU; "bws" lowers the fine
    level to K2's layout (its plain product here) and gives the same
    cycle."""
    _, Ht = _pair("fem20")
    h_auto = tamg.build_sa_hierarchy_device(Ht, dtype=np.float64,
                                            device="cpu")
    h_bws = tamg.build_sa_hierarchy_device(Ht, dtype=np.float64,
                                           fine_format="bws", device="cpu")
    assert isinstance(h_auto.levels[-1].A_dev, pt.EllMatrix)
    assert isinstance(h_bws.levels[-1].A_dev, BwsCsrMatrix)
    f = torch.from_numpy(np.random.default_rng(6).standard_normal(
        Ht.shape[0]))
    y_a = tamg.v_cycle(h_auto, f, torch.zeros_like(f)).numpy()
    y_b = tamg.v_cycle(h_bws, f, torch.zeros_like(f)).numpy()
    assert _rel(y_b, y_a) <= 1e-12


@pytest.mark.parametrize("order", ["shuffled", "rcm"])
def test_pack_fits_refuses_only_what_the_pack_refuses(order):
    """pack_fits (O(nnz), no pack) is False only where the pack raises:
    the shuffled FEM numbering at n = 39,601 is too unbanded for a BWS
    window, its RCM ordering packs."""
    A = pt.problems.fem_poisson_2d_unstructured(200, seed=3)
    if order == "rcm":
        A = A.permute_symmetric(pt.BwsMatrix._rcm_perm(A))
    fits = pack_fits(A, 32)
    assert fits == (order == "rcm")
    try:
        pt.BwsMatrix.from_host_csr(A, dtype=np.float64, use_rcm=False,
                                   group_rows=32, gt="auto", device="cpu")
        packed = True
    except ValueError as e:
        assert "window overflow" in str(e)
        packed = False
    assert packed == fits


@pytest.mark.parametrize("fits", [True, False])
def test_fine_level_lowered_only_where_the_pack_fits(fits, monkeypatch):
    """Under the card's rule ("auto" brings the fine level into the BWS
    lane) a matrix that pack_fits refuses keeps the product operator and
    is not lowered; one it takes is K2's layout."""
    monkeypatch.setattr(amg_setup.api, "_bws_route", lambda device: True)
    monkeypatch.setattr(tbws, "pack_fits", lambda H, gr: fits)
    _, Ht = _pair("fem20")
    Timer.reset()
    h = tamg.build_sa_hierarchy_device(Ht, dtype=np.float64, device="cpu")
    assert Timer.calls("amg.csr_lowerings") == int(fits)
    assert Timer.calls("amg.device_bws") == 1
    Timer.reset()
    assert isinstance(h.levels[-1].A_dev,
                      BwsCsrMatrix if fits else pt.EllMatrix)


def test_tf32_is_off_inside_the_products(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with amg_setup._exact_matmuls():
        assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32
    _, Ht = _pair("fd24")
    tamg.build_sa_hierarchy_device(Ht, dtype=np.float32, device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32


def test_mesh_waits_for_slice_12():
    """mesh= is ported (tests/test_torch_parallel.py checks the build
    against JAX's); what is not a port Mesh is refused."""
    _, Ht = _pair("fd24")
    with pytest.raises(TypeError, match="make_mesh"):
        amg_setup.build_distributed_hierarchy(Ht, mesh=object(),
                                              device="cpu")
