"""The files of the cells ``gmg_poisson_1e8.resolve`` and
``fem_p1_poisson_1M.fresh_lognormal``: the row-wise operator against
``fd5_laplacian_2d``, the card-only DIA operand against the program's own
lowering, the log-normal variation against a direct assembly, and whole
runs of both cells at small sizes on the CPU (sound: correct; x0 handed
back: not correct) and, marked ``cuda``, on the card."""
import time

import numpy as np
import pytest
import torch

from solverbench import run as cli
from solverbench.lib import loop, spec as S
from solverbench.lib.csr import from_coo, from_scipy
from solverbench.lib.traffic import Traffic
from solverbench.reference import residual

GMG_CELL = "gmg_poisson_1e8.resolve"
LOGNORMAL_CELL = "fem_p1_poisson_1M.fresh_lognormal"
NEW_CELLS = [GMG_CELL, LOGNORMAL_CELL]
BIG_SEED = 2**31 + 4321


def small_run(cell, device="cpu", seed=BIG_SEED, trace=False, **kw):
    """One run of a new cell at a small size: the GMG grid at m = 63 with
    4 levels (the configuration's V-cycle otherwise), the FEM mesh at 33
    cells a side; every solve checked."""
    spec = S.load_spec()
    w = S.workload(spec, cell)
    cfg = S.config(spec, w["config"])
    if w["config"] == "gmg_poisson_1e8":
        cfg["operator"]["m"] = 63
        cfg["solver"]["precond"].update(dims=[63, 63], num_levels=4)
    else:
        cfg["operator"]["m"] = 33
    kw.setdefault("check_every", 1)
    kw.setdefault("max_solves", 3)
    return loop.run_cell(cfg, S.mix(w["traffic"]), seed, 30.0, trace,
                         device, time.perf_counter(), **kw)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.parametrize("m", [1, 2, 7, 31])
def test_the_rowwise_operator_is_fd5_entry_for_entry(m):
    A = S.build_operator({"kind": "fd5_laplacian_2d", "m": m})
    B = S.build_operator({"kind": "fd5_laplacian_2d_rows", "m": m})
    for a, b in ((A.indptr, B.indptr), (A.indices, B.indices),
                 (A.data, B.data)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_the_card_only_operand_is_the_programs_dia(monkeypatch, dtype):
    from pysolvers_tpu_torch.sparse.device import DiaMatrix
    from pysolvers_tpu_torch.sparse.host import HostCSR
    make = S.plugin("operands", "dia_on_card")
    monkeypatch.setattr(make, "CHUNK", 700)       # several row chunks
    A = S.build_operator({"kind": "fd5_laplacian_2d_rows", "m": 45})
    D = make.make(A, dtype, "cpu")
    ref = DiaMatrix.from_host_csr(
        HostCSR(A.indptr, A.indices, A.data.astype(dtype), (A.n, A.n)),
        device="cpu")
    assert D.offsets == ref.offsets and D.shape == ref.shape
    assert D.diags.dtype == ref.diags.dtype
    assert torch.equal(D.diags, ref.diags)
    assert torch.equal(D.offsets_dev, ref.offsets_dev)


def _fem(m):
    return S.build_operator({"kind": "fem_p1_unstructured_2d", "m": m,
                             "mesh_seed": 3, "order": "rcm"})


def _direct(m, coefficient):
    """The FEM operator with a coefficient per element, assembled from COO
    triplets by scipy and put in RCM order."""
    import scipy.sparse as sp
    V = S.plugin("variations", "lognormal_coefficient")
    K0, _, tri_ids, n = V.mesh(m, 3, 0.22)
    el, k, l_, r, c = V.element_terms(tri_ids)
    A = from_coo(r, c, coefficient[el] * K0[el, k, l_], n)
    perm = V.order_permutation("rcm", r, c, n)
    M = sp.csr_matrix((A.data, A.indices, A.indptr), shape=(n, n))
    return from_scipy(M[perm][:, perm])


@pytest.mark.parametrize("m", [5, 17, 33])
def test_the_mesh_copy_gives_the_operator(m):
    V = S.plugin("variations", "lognormal_coefficient")
    _, centroids, _, _ = V.mesh(m, 3, 0.22)
    A, B = _fem(m), _direct(m, V.base_coefficient(centroids))
    np.testing.assert_array_equal(A.indptr, B.indptr)
    np.testing.assert_array_equal(A.indices, B.indices)
    np.testing.assert_allclose(A.data, B.data, rtol=1e-13,
                               atol=1e-13 * np.abs(A.data).max())


@pytest.mark.parametrize("m", [9, 33])
def test_the_lognormal_values_are_a_direct_assembly(m):
    """Each draw's values, on A's pattern and in A's order, are the direct
    assembly of its coefficient; b is A_k x*; one seed, one sequence."""
    V = S.plugin("variations", "lognormal_coefficient")
    A = _fem(m)
    mix = S.mix("fresh_lognormal")
    t = Traffic(mix, A, BIG_SEED, "cpu")
    assert not t.frozen
    draws = [t.draw() for _ in range(2)]
    _, centroids, _, _ = V.mesh(m, 3, 0.22)
    fields = _fields(mix, A.n, centroids, BIG_SEED, 2)
    for (x_star, values, b), kappa in zip(draws, fields):
        Ak = t.host(values)
        assert Ak.indptr is A.indptr and Ak.indices is A.indices
        ref = _direct(m, kappa)
        np.testing.assert_array_equal(ref.indptr, A.indptr)
        np.testing.assert_array_equal(ref.indices, A.indices)
        np.testing.assert_allclose(Ak.data, ref.data, rtol=1e-12,
                                   atol=1e-12 * np.abs(ref.data).max())
        Ax = residual.csr_matvec(Ak.indptr, Ak.indices, Ak.data,
                                 x_star.numpy())
        np.testing.assert_allclose(b.numpy(), Ax, rtol=1e-12,
                                   atol=1e-12 * np.abs(Ax).max())
    assert not np.allclose(t.host(draws[0][1]).data, t.host(draws[1][1]).data)
    again = Traffic(mix, A, BIG_SEED, "cpu").draw()
    assert torch.equal(again[1], draws[0][1])


def _fields(mix, n, centroids, seed, count):
    """κ_e = exp(g(c_e)) of the first ``count`` draws of ``seed``, from the
    generator's uniforms in the traffic's order (x*, then the field's):
    σ·sqrt(2/K)·Σ cos(ω_j·c + φ_j), ω = z / (ℓ|u|), φ uniform on
    [0, 2π), normals by Box–Muller."""
    gen = torch.Generator().manual_seed(seed % (1 << 63))

    def uniform(*shape):
        return torch.rand(shape, generator=gen, dtype=torch.float64).numpy()

    def normal(*shape):
        u1, u2 = 1.0 - uniform(*shape), uniform(*shape)
        return np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)
    K, out = mix["modes"], []
    for _ in range(count):
        uniform(n)                                      # x*
        z, u = normal(K, 2), normal(K)
        omega = z / (mix["corr_len"] * np.abs(u))[:, None]
        phi = 2.0 * np.pi * uniform(K)
        g = np.sqrt(2.0 * mix["sigma2"] / K) * np.cos(
            centroids @ omega.T + phi).sum(axis=1)
        out.append(np.exp(g))
    return out


@pytest.mark.parametrize("cell", NEW_CELLS)
def test_a_small_run_of_a_new_cell_is_correct(cell):
    r = small_run(cell)
    assert r.correct, r.checks
    assert len(r.solves) == 3 and r.failed == 0
    out = cli.result(S.load_spec(), cell, r, False, "cpu")
    e2e = {m["name"] for m in S.cell_metrics(S.load_spec(), cell,
                                             "end_to_end")}
    assert set(out["metrics"]) == e2e


def test_the_gmg_run_hands_the_solver_no_host_matrix(monkeypatch):
    from pysolvers_tpu_torch.api import PCGSolver
    from pysolvers_tpu_torch.sparse.device import DiaMatrix
    seen = []
    solve = PCGSolver.solve

    def spy(self, A, b):
        seen.append(type(A))
        return solve(self, A, b)
    monkeypatch.setattr(PCGSolver, "solve", spy)
    assert small_run(GMG_CELL, max_solves=2).correct
    assert set(seen) == {DiaMatrix}


@pytest.mark.parametrize("cell", NEW_CELLS)
def test_x0_handed_back_is_not_correct(monkeypatch, cell):
    from pysolvers_tpu_torch.api import PCGSolver
    solve = PCGSolver.solve

    def broken(self, A, b):
        st = solve(self, A, b)
        st.soln = torch.zeros_like(st.soln)
        return st
    monkeypatch.setattr(PCGSolver, "solve", broken)
    r = small_run(cell, max_solves=2)
    assert not r.correct
    assert r.checks["resid_max"]["value"] > r.checks["resid_max"]["limit"]


def test_a_traced_small_gmg_run_reads_the_programs_spans():
    """On the CPU the trace holds no kernel: only the span reader reads."""
    r = small_run(GMG_CELL, trace=True, max_solves=2)
    out = cli.result(S.load_spec(), GMG_CELL, r, True, "cpu")
    assert r.correct
    assert set(out["metrics"]) == {"gmg.apply_host_ms"}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", NEW_CELLS)
def test_small_runs_of_the_new_cells_on_the_card(cuda_device, cell):
    r = small_run(cell, device=cuda_device, trace=True)
    out = cli.result(S.load_spec(), cell, r, True, cuda_device)
    assert r.correct, r.checks
    assert out["device"]["busy_s"] > 0
    per_layer = {m["name"] for m in S.cell_metrics(S.load_spec(), cell,
                                                   "per_layer")}
    assert set(out["metrics"]) <= per_layer
    if cell == GMG_CELL:
        assert {"gmg.apply_host_ms", "gmg.device_ms_per_iter",
                "device.idle.gmg"} <= set(out["metrics"])
