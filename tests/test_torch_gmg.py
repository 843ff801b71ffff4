"""The port's geometric multigrid against the JAX package (f64).

Host layer (interpolation, refinement, Galerkin sequence, Ruge-Stueben
coarsening): bit-equal, since both run the same numpy code.  Structured
transfers: within 1e-15 relative of JAX and of the host P/R.  Hierarchies:
tables and 1/diag within 1e-12, the coarsest inverse within 1e-10
(np.linalg.inv or torch.linalg.inv against JAX's Gauss-Jordan), Chebyshev
bounds within 1e-12 relative.  V-cycles within 1e-12 relative (only the
summation order inside SpMVs and the coarse matmul differs).  Solves: the
same iteration count as JAX and solutions within 1e-9 relative."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysolvers_tpu as pst
from pysolvers_tpu.linear import amg as jamg
from pysolvers_tpu.linear import amg_rs as jrs
from pysolvers_tpu.linear import gmg as jgmg
from pysolvers_tpu.linear import gmg_grid as jgg
from pysolvers_tpu.ops.grid_spmv import GridDiaMatrix as JaxGrid
from pysolvers_tpu.problems import fem as jfem
from pysolvers_tpu.sparse.device import DiaMatrix as JaxDia
import pysolvers_tpu_torch as pt
from pysolvers_tpu_torch import convert
from pysolvers_tpu_torch.linear import amg as tamg
from pysolvers_tpu_torch.linear import amg_rs as trs
from pysolvers_tpu_torch.linear import gmg as tgmg
from pysolvers_tpu_torch.linear import gmg_grid as tgg
from pysolvers_tpu_torch.ops import grid_spmv
from pysolvers_tpu_torch.sparse.device import DiaMatrix

torch.set_num_threads(1)


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(
        np.asarray(b))


def _same_csr(a, b):
    assert tuple(a.shape) == tuple(b.shape)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def _problem(ndim, m):
    if ndim == 1:
        return (pst.problems.fd_laplacian_1d(m),
                pt.problems.fd_laplacian_1d(m), (m,))
    return (pst.problems.fd_laplacian_2d(m), pt.problems.fd_laplacian_2d(m),
            (m, m))


def _jdia(op):
    return op.to_dia() if hasattr(op, "to_dia") else op


# ---------------------------------------------------------------------------
# Host layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ndim", [1, 2])
@pytest.mark.parametrize("m_c", [3, 7])
def test_interpolation_is_bit_equal(ndim, m_c):
    m_f = 2 * m_c + 1
    fj, ft = ((jgmg.interp_1d, tgmg.interp_1d) if ndim == 1
              else (jgmg.interp_2d, tgmg.interp_2d))
    _same_csr(ft(m_f, m_c), fj(m_f, m_c))


def test_refinement_ms_and_its_refusal():
    assert list(tgmg.refinement_ms(10239, 10)) == list(
        jgmg.refinement_ms(10239, 10))
    assert tgmg.refinement_ms(10239, 10)[-1] == 19
    with pytest.raises(ValueError, match="cannot be uniformly"):
        tgmg.refinement_ms(30, 2)
    with pytest.raises(ValueError, match="2\\*m_coarse"):
        tgmg.interp_1d(14, 7)


@pytest.mark.parametrize("ndim,m,levels", [(1, 31, 3), (2, 15, 3),
                                           (2, 31, 3)])
def test_gmg_hierarchy_is_bit_equal(ndim, m, levels):
    Hj, Ht, dims = _problem(ndim, m)
    hj = jgmg.build_gmg_hierarchy(Hj, levels, dims)
    ht = tgmg.build_gmg_hierarchy(Ht, levels, dims)
    assert ht.n_levels == hj.n_levels == levels
    for name in ("matrices", "prolongators", "restrictions"):
        for a, b in zip(getattr(ht, name), getattr(hj, name)):
            _same_csr(a, b)


def _fem(n_side=20):
    return (jfem.fem_poisson_2d_unstructured(n_side, seed=3),
            pt.problems.fem_poisson_2d_unstructured(n_side, seed=3))


@pytest.mark.parametrize("problem", ["laplacian_31", "fem"])
def test_rs_coarsening_is_bit_equal(problem):
    Hj, Ht = (_problem(2, 31)[:2] if problem == "laplacian_31" else _fem())
    np.testing.assert_array_equal(trs.rs_cf_split(Ht), jrs.rs_cf_split(Hj))
    for a, b in zip(trs.rs_coarsen(Ht), jrs.rs_coarsen(Hj)):
        _same_csr(a, b)


def test_sa_hierarchy_with_rs_coarsening_matches_jax():
    Hj, Ht = _fem()
    hj = jamg.build_sa_hierarchy(Hj, 3, coarsening="rs")
    ht = tamg.build_sa_hierarchy(Ht, 3, coarsening="rs")
    assert ht.n_levels == hj.n_levels
    for name in ("matrices", "prolongators", "restrictions"):
        for a, b in zip(getattr(ht, name), getattr(hj, name)):
            _same_csr(a, b)


# ---------------------------------------------------------------------------
# Structured transfers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ndim", [1, 2])
@pytest.mark.parametrize("m_c", [3, 15])
def test_grid_transfers_match_jax_and_host_operators(ndim, m_c):
    m_f = 2 * m_c + 1
    P = (tgmg.interp_1d if ndim == 1 else tgmg.interp_2d)(m_f, m_c)
    R = tamg.make_restriction(P)
    rng = np.random.default_rng(ndim)
    xc, xf = rng.random(m_c ** ndim), rng.random(m_f ** ndim)
    up = tgg.grid_prolong(torch.from_numpy(xc), ndim, m_c, m_f).numpy()
    down = tgg.grid_restrict(torch.from_numpy(xf), ndim, m_f, m_c).numpy()
    assert _rel(up, jgg.grid_prolong(jnp.asarray(xc), ndim, m_c, m_f)) \
        <= 1e-15
    assert _rel(down, jgg.grid_restrict(jnp.asarray(xf), ndim, m_f, m_c)) \
        <= 1e-15
    assert _rel(up, P.matvec(xc)) <= 1e-15
    assert _rel(down, R.matvec(xf)) <= 1e-15


# ---------------------------------------------------------------------------
# Hierarchies
# ---------------------------------------------------------------------------

def _tables_match(Lt, Lj, k):
    """Level operators entry by entry through an offset dict (host tables
    carry the nonzero offsets only, probed ones the full reach box)."""
    At, Aj = Lt.A_dev, _jdia(Lj.A_dev)
    n = At.shape[0]
    want = {o: np.asarray(Aj.diags[i][:n]) for i, o in enumerate(Aj.offsets)}
    got = {o: At.diags[i, :n].numpy() for i, o in enumerate(At.offsets)}
    for o in set(want) | set(got):
        np.testing.assert_allclose(got.get(o, np.zeros(n)),
                                   want.get(o, np.zeros(n)), rtol=0,
                                   atol=1e-12 * np.abs(want[0]).max(),
                                   err_msg=f"level {k} offset {o}")


def _cheb_match(ct, cj):
    if cj is None:
        assert ct is None
        return
    for a, b in zip(ct, cj):
        assert abs(a - float(b)) <= 1e-12 * abs(float(b))


@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
def test_host_grid_hierarchy_matches_jax(smoother):
    Hj, Ht, dims = _problem(2, 15)
    hj = jgg.build_grid_hierarchy(Hj, 3, dims, smoother=smoother,
                                  dtype=np.float64)
    ht = tgg.build_grid_hierarchy(Ht, 3, dims, smoother=smoother,
                                  dtype=np.float64, device="cpu")
    assert ht.ms == hj.ms and ht.smoother == smoother
    for k in range(1, 3):
        _tables_match(ht.levels[k], hj.levels[k], k)
        np.testing.assert_allclose(ht.levels[k].dinv.numpy(),
                                   np.asarray(hj.levels[k].dinv), rtol=1e-12)
        _cheb_match(ht.levels[k].cheb, hj.levels[k].cheb)
    np.testing.assert_allclose(ht.A0_inv.numpy(), np.asarray(hj.A0_inv),
                               rtol=0, atol=1e-12 * np.abs(
                                   np.asarray(hj.A0_inv)).max())


DEVICE_CASES = [(1, 31, 3), (2, 15, 3), (2, 31, 4)]


@pytest.fixture(scope="module")
def device_hierarchies():
    """JAX device-probed hierarchies (Chebyshev smoother, so that the
    bounds are built too), one per case."""
    out = {}
    for ndim, m, levels in DEVICE_CASES:
        Hj, Ht, dims = _problem(ndim, m)
        hj = jgg.build_grid_hierarchy_device(
            JaxDia.from_host_csr(Hj, dtype=np.float64), levels, dims,
            smoother="chebyshev")
        out[(ndim, m, levels)] = (hj, Ht, dims)
    return out


@pytest.mark.parametrize("case", DEVICE_CASES)
def test_device_grid_hierarchy_matches_jax(device_hierarchies, case):
    hj, Ht, dims = device_hierarchies[case]
    ht = tgg.build_grid_hierarchy_device(DiaMatrix.from_host_csr(
        Ht, device="cpu"), case[2], dims, smoother="chebyshev")
    assert ht.ms == hj.ms and ht.n_levels == hj.n_levels
    for k in range(1, ht.n_levels):
        Lt, Lj = ht.levels[k], hj.levels[k]
        # the probed offset tuples are the JAX tuples, element by element
        assert Lt.A_dev.offsets == tuple(_jdia(Lj.A_dev).offsets)
        assert Lt.A_dev.offsets == tgg._probed_offsets(
            tuple(_jdia(hj.levels[-1].A_dev).offsets), ht.ms, ht.ndim, k)
        _tables_match(Lt, Lj, k)
        np.testing.assert_allclose(Lt.dinv.numpy(), np.asarray(Lj.dinv),
                                   rtol=1e-12)
        _cheb_match(Lt.cheb, Lj.cheb)
    np.testing.assert_allclose(ht.A0_inv.numpy(), np.asarray(hj.A0_inv),
                               rtol=0, atol=1e-10 * np.abs(
                                   np.asarray(hj.A0_inv)).max())


def test_chunked_probe_equals_one_batch(monkeypatch):
    """The comb chunks of huge grids give the table of one batch."""
    _, Ht, _ = _problem(2, 31)
    A = DiaMatrix.from_host_csr(Ht, device="cpu")
    whole = tgg._probe_coarse_dia(A, 2, 31, 15)
    monkeypatch.setattr(tgg, "_PROBE_CHUNK_N", 100)
    chunked = tgg._probe_coarse_dia(A, 2, 31, 15)
    assert chunked.offsets == whole.offsets
    np.testing.assert_array_equal(chunked.diags.numpy(), whole.diags.numpy())


def _vc(h, f, x0):
    return tgg.v_cycle_grid(h, torch.from_numpy(f),
                            torch.from_numpy(x0)).numpy()


def test_lowered_threshold_gives_grid_levels(device_hierarchies,
                                             monkeypatch):
    """With the K6 threshold lowered, the probed 2-D levels of m >= 7 are
    GridDiaMatrix (the twin on the CPU), and the V-cycle is JAX's."""
    hj, Ht, dims = device_hierarchies[(2, 31, 4)]
    monkeypatch.setattr(tgg, "GRID_KERNEL_MIN_M", 7)
    for smoother in ("jacobi", "chebyshev"):
        ht = tgg.build_grid_hierarchy_device(DiaMatrix.from_host_csr(
            Ht, device="cpu"), 4, dims, smoother=smoother)
        kinds = [type(L.A_dev).__name__ for L in ht.levels[1:]]
        assert kinds == ["GridDiaMatrix"] * 3           # m = 7, 15, 31
        rng = np.random.default_rng(5)
        f, x0 = rng.random(31 * 31), rng.random(31 * 31)
        hj.smoother = smoother
        try:
            y_ref = np.asarray(jgg.v_cycle_grid(hj, jnp.asarray(f),
                                                jnp.asarray(x0)))
        finally:
            hj.smoother = "chebyshev"
        before = grid_spmv.grid_dia_spmv_launches
        assert _rel(_vc(ht, f, x0), y_ref) <= 1e-12
        assert grid_spmv.grid_dia_spmv_launches == before    # CPU: twin


@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
@pytest.mark.parametrize("built", ["host", "device", "converted"])
def test_v_cycle_grid_matches_jax(device_hierarchies, smoother, built):
    Hj, Ht, dims = _problem(2, 15)
    if built == "host":
        hj = jgg.build_grid_hierarchy(Hj, 3, dims, smoother=smoother,
                                      dtype=np.float64)
        ht = tgg.build_grid_hierarchy(Ht, 3, dims, smoother=smoother,
                                      dtype=np.float64, device="cpu")
    else:
        hj = jgg.build_grid_hierarchy_device(
            JaxDia.from_host_csr(Hj, dtype=np.float64), 3, dims,
            smoother=smoother)
        if built == "device":
            ht = tgg.build_grid_hierarchy_device(DiaMatrix.from_host_csr(
                Ht, device="cpu"), 3, dims, smoother=smoother)
        else:
            ht = convert.grid_hierarchy_from_arrays(device="cpu",
                                                    **dump_grid(hj))
    rng = np.random.default_rng(2)
    f, x0 = rng.random(15 * 15), rng.random(15 * 15)
    y_ref = np.asarray(jgg.v_cycle_grid(hj, jnp.asarray(f), jnp.asarray(x0)))
    assert _rel(_vc(ht, f, x0), y_ref) <= 1e-12
    # amg.v_cycle dispatches a GridHierarchy to v_cycle_grid
    y = tamg.v_cycle(ht, torch.from_numpy(f), torch.from_numpy(x0)).numpy()
    np.testing.assert_array_equal(y, _vc(ht, f, x0))


def dump_grid(h):
    """A JAX GridHierarchy as numpy leaves, for convert.py."""
    levels = []
    for L in h.levels:
        A = L.A_dev
        if A is None:
            op = None
        elif isinstance(A, JaxGrid):
            op = dict(diags=np.asarray(A.diags), pairs=A.pairs, dims=A.dims)
        else:
            A = _jdia(A)
            op = dict(diags=np.asarray(A.diags), offsets=A.offsets,
                      shape=A.shape)
        levels.append(dict(
            A=op, dinv=None if L.dinv is None else np.asarray(L.dinv),
            cheb=None if L.cheb is None else tuple(float(c) for c in L.cheb)))
    return dict(levels=levels, A0_inv=np.asarray(h.A0_inv), ms=h.ms,
                ndim=h.ndim, smoother=h.smoother, nu_pre=h.nu_pre,
                nu_post=h.nu_post)


def test_converted_grid_levels_carry_across():
    """A JAX hierarchy whose levels are GridDiaMatrix converts too.  In
    f32: the JAX grid kernel runs its Pallas body in f32 only.  1e-5
    relative: two levels of f32 SpMVs, transfers and a 49-term coarse
    matmul, each summed in another order than JAX's."""
    Hj, Ht, dims = _problem(2, 15)
    hj = jgg.build_grid_hierarchy(Hj, 2, dims, dtype=np.float32)
    fine = _jdia(hj.levels[-1].A_dev)
    hj.levels[-1].A_dev = JaxGrid.from_dia(fine, dims)
    ht = convert.grid_hierarchy_from_arrays(device="cpu", **dump_grid(hj))
    assert isinstance(ht.levels[-1].A_dev, grid_spmv.GridDiaMatrix)
    assert ht.levels[-1].A_dev.dtype == torch.float32
    rng = np.random.default_rng(3)
    f = rng.random(225).astype(np.float32)
    x0 = np.zeros_like(f)
    y_ref = np.asarray(jgg.v_cycle_grid(hj, jnp.asarray(f), jnp.asarray(x0)))
    assert _rel(_vc(ht, f, x0), y_ref) <= 1e-5


def test_grid_executor_refusals():
    _, Ht, dims = _problem(2, 7)
    with pytest.raises(ValueError, match="smoother"):
        tgg.build_grid_hierarchy(Ht, 2, dims, smoother="gs", device="cpu")
    with pytest.raises(ValueError, match="galerkin"):
        tgg.build_grid_hierarchy(Ht, 2, dims, galerkin="probe", device="cpu")
    A = DiaMatrix.from_host_csr(Ht, device="cpu")
    with pytest.raises(ValueError, match="square"):
        tgg.build_grid_hierarchy_device(A, 2, (7, 9))
    with pytest.raises(ValueError, match="does not match"):
        tgg.build_grid_hierarchy_device(A, 2, (9, 9))
    with pytest.raises(ValueError, match="too wide"):
        tgg._stencil_reach((-5, 0, 5), 7, 1)


def test_galerkin_auto_builds_on_the_host_on_cpu():
    _, Ht, dims = _problem(2, 15)
    calls = []
    real = tgg._probe_coarse_dia
    try:
        tgg._probe_coarse_dia = lambda *a: calls.append(1) or real(*a)
        h = tgg.build_grid_hierarchy(Ht, 3, dims, galerkin="auto",
                                     dtype=np.float64, device="cpu")
        assert not calls and h.device.type == "cpu"
        tgg.build_grid_hierarchy(Ht, 3, dims, galerkin="device",
                                 dtype=np.float64, device="cpu")
        assert calls
    finally:
        tgg._probe_coarse_dia = real


# ---------------------------------------------------------------------------
# Checkpoint of the probed products
# ---------------------------------------------------------------------------

@pytest.fixture
def probe_spy(monkeypatch):
    calls = {"n": 0}
    real = tgg._probe_coarse_dia

    def spy(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(tgg, "_probe_coarse_dia", spy)
    return calls


def test_checkpoint_round_trip_and_invalidation(tmp_path, probe_spy):
    _, Ht, dims = _problem(2, 31)
    A = DiaMatrix.from_host_csr(Ht, device="cpu")
    ck = str(tmp_path / "hier.npz")
    h1 = tgg.build_grid_hierarchy_device(A, 3, dims, smoother="chebyshev",
                                         checkpoint=ck)
    assert probe_spy["n"] == 2
    with np.load(ck) as d:
        assert bytes(d["meta_dtype"]).decode() == "float64"
        assert sorted(d.files) == sorted(
            ["meta_ms", "meta_ndim", "meta_cheb", "meta_offsets",
             "meta_dtype", "meta_fp", "A0_inv", "tbl_0", "dinv_0", "cheb_0"])
    probe_spy["n"] = 0
    h2 = tgg.build_grid_hierarchy_device(A, 3, dims, smoother="chebyshev",
                                         checkpoint=ck)
    assert probe_spy["n"] == 0                  # warm: no probing
    f = np.random.default_rng(0).random(31 * 31)
    x0 = np.zeros_like(f)
    np.testing.assert_array_equal(_vc(h1, f, x0), _vc(h2, f, x0))
    assert h2.levels[1].cheb == h1.levels[1].cheb
    # different values -> digest mismatch -> rebuild (and overwrite)
    A2 = DiaMatrix(A.diags * 2.0, A.offsets, A.offsets_dev, A.shape)
    h3 = tgg.build_grid_hierarchy_device(A2, 3, dims, smoother="chebyshev",
                                         checkpoint=ck)
    assert probe_spy["n"] == 2
    assert not np.array_equal(_vc(h3, f, x0), _vc(h1, f, x0))
    # a different smoother (no Chebyshev bounds stored) rebuilds too
    probe_spy["n"] = 0
    tgg.build_grid_hierarchy_device(A2, 3, dims, checkpoint=ck)
    assert probe_spy["n"] == 2


def test_jax_checkpoint_loads_in_the_port(tmp_path, probe_spy, monkeypatch):
    Hj, Ht, dims = _problem(2, 31)
    monkeypatch.setattr(jgg, "_SPLIT_BUILD_N", 100)   # JAX's split path
    ck = str(tmp_path / "jax.npz")
    hj = jgg.build_grid_hierarchy_device(
        JaxDia.from_host_csr(Hj, dtype=np.float64), 4, dims, checkpoint=ck)
    ht = tgg.build_grid_hierarchy_device(
        DiaMatrix.from_host_csr(Ht, device="cpu"), 4, dims, checkpoint=ck)
    assert probe_spy["n"] == 0
    f = np.random.default_rng(1).random(31 * 31)
    x0 = np.zeros_like(f)
    y_ref = np.asarray(jgg.v_cycle_grid(hj, jnp.asarray(f), jnp.asarray(x0)))
    assert _rel(_vc(ht, f, x0), y_ref) <= 1e-12


# ---------------------------------------------------------------------------
# Solves
# ---------------------------------------------------------------------------

def _agree(st, sj):
    assert st.success and sj.success
    assert st.reason == sj.reason
    assert st.iters == sj.iters
    assert _rel(st.soln.numpy(), np.asarray(sj.soln)) <= 1e-9


def _rhs(H, seed):
    return H.matvec(np.random.default_rng(seed).random(H.shape[0]))


@pytest.mark.parametrize("variant", ["grid_host", "grid_device", "sparse"])
def test_pcg_gmg_factory_matches_jax(variant):
    m = 31
    Hj, Ht, dims = _problem(2, m)
    b = _rhs(Ht, 6)
    kw = dict(num_iters=2, num_levels=3, smoother="jacobi")
    if variant == "sparse":
        kw["executor"] = "sparse"
    else:
        kw["galerkin"] = variant[5:]
    args = dict(maxiter=100, tau=1e-10)
    sj = pst.PCG(pst.CommonSolverArgs(**args),
                 precond=pst.GMGPreconditionerType(dims, **kw)
                 ).make_solver().solve(Hj, b)
    solver = pt.PCG(pt.CommonSolverArgs(**args),
                    precond=pt.GMGPreconditionerType(dims, **kw),
                    device="cpu").make_solver()
    st = solver.solve(Ht, b)
    _agree(st, sj)
    h = solver._formed_prec.state
    assert type(h).__name__ == ("DeviceHierarchy" if variant == "sparse"
                                else "GridHierarchy")


@pytest.mark.parametrize("matrix_format", ["grid", "auto"])
def test_gmg_vcycle_solver_matches_jax(matrix_format):
    m = 31
    Hj, Ht, dims = _problem(2, m)
    b = _rhs(Ht, 7)
    kw = dict(dims=dims, num_levels=3, smoother="jacobi", nu_pre=2,
              nu_post=2, matrix_format=matrix_format)
    sj = pst.GMGVCycle(pst.SolverConfig(maxiter=60, tau=1e-10),
                       **kw).make_solver().solve(Hj, b)
    solver = pt.GMGVCycle(pt.SolverConfig(maxiter=60, tau=1e-10),
                          device="cpu", **kw).make_solver()
    st = solver.solve(Ht, b)
    _agree(st, sj)
    assert type(solver._hierarchy).__name__ == (
        "GridHierarchy" if matrix_format == "grid" else "DeviceHierarchy")


def test_gmg_vcycle_default_smoother_on_the_grid_executor():
    _, Ht, dims = _problem(2, 31)
    x_star = np.random.default_rng(6).random(31 * 31)
    st = pt.GMGVCycle(pt.SolverConfig(maxiter=60, tau=1e-10), dims=dims,
                      num_levels=3, matrix_format="grid",
                      device="cpu").make_solver().solve(Ht,
                                                        Ht.matvec(x_star))
    assert st.success
    assert np.linalg.norm(st.soln.numpy() - x_star) < 1e-7


def test_pcg_amg_chebyshev_smoother_matches_jax():
    m = 31
    Hj, Ht, _ = _problem(2, m)
    b = _rhs(Ht, 8)
    args = dict(maxiter=100, tau=1e-10)
    kw = dict(num_iters=2, num_levels=3, smoother="chebyshev")
    sj = pst.PCG(pst.CommonSolverArgs(**args), precond=pst.AMG(**kw)
                 ).make_solver().solve(Hj, b)
    solver = pt.PCG(pt.CommonSolverArgs(**args), precond=pt.AMG(**kw),
                    device="cpu").make_solver()
    _agree(solver.solve(Ht, b), sj)
    h = solver._formed_prec.state
    assert h.smoother == "chebyshev" and h.levels[0].cheb is None
    assert all(L.cheb is not None for L in h.levels[1:])


def test_chebyshev_preconditioner_matches_jax():
    m = 24
    Hj, Ht, _ = _problem(2, m)
    b = _rhs(Ht, 9)
    args = dict(maxiter=300, tau=1e-10)
    typ_j = pst.ChebyshevPreconditionerType(degree=4)
    typ_t = pt.ChebyshevPreconditionerType(degree=4)
    assert typ_t.estimate_lmax(Ht) == typ_j.estimate_lmax(Hj)
    r = np.random.default_rng(0).random(m * m)
    pj = typ_j.form(Hj, JaxDia.from_host_csr(Hj))
    ptc = typ_t.form(Ht, DiaMatrix.from_host_csr(Ht, device="cpu"))
    assert _rel(ptc.apply_any(torch.from_numpy(r)).numpy(),
                np.asarray(pj.apply_any(jnp.asarray(r)))) <= 1e-12
    sj = pst.PCG(pst.CommonSolverArgs(**args), precond=typ_j
                 ).make_solver().solve(Hj, b)
    st = pt.PCG(pt.CommonSolverArgs(**args), precond=typ_t,
                device="cpu").make_solver().solve(Ht, b)
    _agree(st, sj)
    with pytest.raises(ValueError, match="device matrix"):
        typ_t.form(Ht)
