"""The scalar multi-RHS routes (slice 10's rest) of the port against the
JAX package on the same inputs, k = 3, n <= 961, f64: ``solve(A, B)``'s
lockstep CG and GMRES, the column loop, the direct solve and the mixed
routes (DIA, ELL, and the BWS route the card takes); the same stop reason,
iterations within ±1, solutions within 1e-10 relative at native precision
and 1e-8 at mixed (the loops round their dots in other orders).  Also
``matmat`` on ELL (``ell_spmm_torch``, within 1e-14 of ``ell_spmm_xla``)
and BWS (its twin per column, within 1e-14 of the host product), and the
BWS pack cache (a hit gives the pack bit for bit)."""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysolvers_tpu as pst
import pysolvers_tpu_torch as pt
from pysolvers_tpu.linear import amg as jamg
from pysolvers_tpu.linear.krylov import cg_solve_multi as jcg_multi
from pysolvers_tpu.ops import spmv as jspmv
from pysolvers_tpu.problems import fem as jfem
from pysolvers_tpu.problems import laplacian as jlap
from pysolvers_tpu.sparse.bws import BwsMatrix as JaxBws
from pysolvers_tpu.sparse.host import HostCSR as JaxCSR
from pysolvers_tpu_torch import api as tapi
from pysolvers_tpu_torch.linear import amg as tamg
from pysolvers_tpu_torch.linear import krylov as tkrylov
from pysolvers_tpu_torch.ops import spmv
from pysolvers_tpu_torch.sparse import bws as tbws

torch.set_num_threads(1)
K = 3


def _rel(x, y):
    x, y = np.asarray(x), np.asarray(y)
    return float(np.linalg.norm(x - y) / np.linalg.norm(y))


def _system(kind, m):
    if kind == "lap":
        Hj, Ht = jlap.fd_laplacian_2d(m), pt.problems.fd_laplacian_2d(m)
    elif kind == "cd":
        Hj, Ht = (jlap.fd_convection_diffusion_2d(m),
                  pt.fd_convection_diffusion_2d(m))
    else:
        Hj = jfem.fem_poisson_2d_unstructured(m, seed=3)
        Ht = pt.problems.fem_poisson_2d_unstructured(m, seed=3)
    X = np.random.default_rng(4).random((K, Hj.shape[0]))
    return Hj, Ht, np.stack([Hj.matvec(c) for c in X], axis=1)


def _agree(st, sj, tol):
    assert st.reason == sj.reason and st.success == sj.success
    assert abs(st.iters - sj.iters) <= 1
    assert tuple(st.soln.shape) == tuple(np.shape(sj.soln))
    assert _rel(st.soln.cpu().numpy(), sj.soln) <= tol


@pytest.mark.parametrize("kind, m, kw", [
    ("lap", 24, dict(method="cg")),                         # + IC(t)
    ("lap", 24, dict(method="cg", precond="amg")),
    ("cd", 15, dict()),                                     # GMRES + ILUT
    ("cd", 15, dict(restart=12, precond="none")),
    ("cd", 15, dict(orthog="cgs2")),                        # column loop
    ("lap", 20, dict(method="direct")),                     # n = 400
])
def test_native_routes_match_jax(kind, m, kw):
    Hj, Ht, B = _system(kind, m)
    sj = pst.solve(Hj, B, tau=1e-10, **kw)
    st = pt.solve(Ht, B, tau=1e-10, device="cpu", **kw)
    _agree(st, sj, 1e-10)
    assert st.soln.dtype == torch.float64 and st.soln.device.type == "cpu"


def test_gmres_lockstep_reads_the_host_once_per_step(monkeypatch):
    _, Ht, B = _system("cd", 15)
    reads = []
    host = tkrylov._host
    monkeypatch.setattr(tkrylov, "_host",
                        lambda t: reads.append(1) or host(t))
    A = pt.DiaMatrix.from_host_csr(Ht, device="cpu")
    X, st, _ = tkrylov.gmres_solve_multi(
        lambda V: pt.matmat(A, V), torch.as_tensor(B), maxiter=200,
        tau=1e-10)
    steps = int(st.k.max())
    # per cycle: the residual norms at its start and end; one cycle here
    assert len(reads) == steps + 3
    assert bool((st.reason == pt.StopReason.CONVERGED).all())


def _jacobi_amg(monkeypatch):
    """The "auto" AMG smoother of both packages set to "jacobi", the one
    they take on an accelerator (on the CPU both take "gs")."""
    for mod in (jamg, tamg):
        real = mod.build_device_hierarchy
        monkeypatch.setattr(
            mod, "build_device_hierarchy",
            lambda mlh, smoother="auto", *a, _real=real, **k: _real(
                mlh, "jacobi" if smoother == "auto" else smoother, *a, **k))


@pytest.mark.parametrize("kind, m, kw", [
    ("lap", 24, dict(method="cg")),                         # DIA, IC(t)
    ("lap", 24, dict(method="cg", precond="amg")),          # AMG, Jacobi
    ("lap", 31, dict(method="cg", precond="amg")),
    ("cd", 15, dict(precond="ilut")),                       # GMRES, DIA
    ("fem", 21, dict(method="cg", precond="jacobi")),       # ELL
])
def test_mixed_routes_match_jax(kind, m, kw, monkeypatch):
    """The AMG cases smooth by Jacobi in both packages, as on the card:
    with the CPU's "gs" the V-cycle is not symmetric
    (``test_gs_vcycle_is_the_same_nonsymmetric_operator``), CG loses its
    conjugacy, and the per-column counts of either package range over
    13-1000 when B moves by one f32 rounding
    (``tests/mixed_count_spread.py amg``), so no count of one is a gate
    for the other."""
    if kw.get("precond") == "amg":
        _jacobi_amg(monkeypatch)
    Hj, Ht, B = _system(kind, m)
    sj = pst.solve(Hj, B, tau=1e-10, precision="mixed", **kw)
    st = pt.solve(Ht, B, tau=1e-10, precision="mixed", device="cpu", **kw)
    _agree(st, sj, 1e-8)
    assert st.soln.dtype == torch.float64


@pytest.mark.parametrize("smoother, asym", [("gs", (1e-3, 1e-1)),
                                            ("jacobi", (0.0, 1e-14))])
def test_gs_vcycle_is_the_same_nonsymmetric_operator(smoother, asym):
    """AMG(2, 2)'s f64 V-cycle as a matrix, column by column: the same
    operator in both packages (within 1e-12), and with "gs" not symmetric
    (the same one-way sweep before and after the coarse correction), with
    "jacobi" symmetric to rounding."""
    Hj, Ht, _ = _system("lap", 12)
    n = Hj.shape[0]
    _, Aj = pst.api.as_device_matrix(Hj)
    Mj = np.asarray(jax.vmap(
        pst.AMG(num_iters=2, num_levels=2, smoother=smoother).form(
            Hj, Aj).apply_any, in_axes=1, out_axes=1)(jnp.eye(n)))
    At = pt.DiaMatrix.from_host_csr(Ht, device="cpu")
    pc = pt.AMG(num_iters=2, num_levels=2, smoother=smoother).form(
        Ht, At, device="cpu")
    Mt = spmv.per_vector(pc.apply_any)(
        torch.eye(n, dtype=torch.float64)).numpy()
    assert _rel(Mt, Mj) <= 1e-12
    for M in (Mj, Mt):
        a = np.linalg.norm(M - M.T) / np.linalg.norm(M)
        assert asym[0] <= a <= asym[1]


def test_mixed_bws_route(monkeypatch):
    """The card's mixed route on an unstructured matrix, on the CPU through
    K2's twin: the RCM-ordered f32 pack inside, the f64 pack as oracle, B
    and X through the pack's ordering."""
    monkeypatch.setattr(tapi, "_bws_route", lambda device: True)
    Hj, Ht, B = _system("fem", 21)
    calls = []
    mm = spmv.matmat
    monkeypatch.setattr(sys.modules["pysolvers_tpu_torch.solve"], "matmat",
                        lambda A, V: calls.append(type(A)) or mm(A, V))
    st = pt.solve(Ht, B, tau=1e-10, method="cg", precond="jacobi",
                  precision="mixed", device="cpu")
    assert st.success and set(calls) == {pt.BwsMatrix}
    sj = pst.solve(Hj, B, tau=1e-10, method="cg", precond="jacobi",
                   precision="mixed")
    assert abs(st.iters - sj.iters) <= 1
    assert _rel(st.soln.numpy(), sj.soln) <= 1e-8
    for j in range(K):
        r = B[:, j] - Ht.matvec(st.soln[:, j].numpy())
        assert np.linalg.norm(r) <= 1e-9 * np.linalg.norm(B[:, j])


def test_cg_solve_multi_matches_jax_with_x0():
    Hj, Ht, B = _system("lap", 16)
    X0 = np.random.default_rng(5).random(B.shape)
    Aj = pst.DiaMatrix.from_host_csr(Hj)
    At = pt.DiaMatrix.from_host_csr(Ht, device="cpu")
    Xj, sj, _ = jcg_multi(lambda V: jspmv.matmat(Aj, V), jnp.asarray(B),
                          jnp.asarray(X0), maxiter=300, tau=1e-10)
    Xt, st, _ = pt.cg_solve_multi(lambda V: pt.matmat(At, V),
                                  torch.as_tensor(B), torch.as_tensor(X0),
                                  maxiter=300, tau=1e-10)
    np.testing.assert_array_equal(st.k.numpy(), np.asarray(sj.k))
    np.testing.assert_array_equal(st.reason.numpy(), np.asarray(sj.reason))
    assert _rel(Xt.numpy(), Xj) <= 1e-10


def test_ell_matmat_matches_jax():
    Hj, Ht, _ = _system("fem", 15)
    X = np.random.default_rng(6).random((Hj.shape[1], 4))
    Yj = jspmv.ell_spmm_xla(pst.EllMatrix.from_host_csr(Hj), jnp.asarray(X))
    Yt = pt.matmat(pt.EllMatrix.from_host_csr(Ht, device="cpu"),
                   torch.as_tensor(X))
    np.testing.assert_allclose(Yt.numpy(), np.asarray(Yj), rtol=1e-14,
                               atol=1e-13)


def test_bws_matmat_is_the_twin_per_column():
    H = pt.problems.fem_poisson_2d_unstructured(19, seed=3)
    A = pt.BwsMatrix.from_host_csr(H, dtype=np.float64, use_rcm=False,
                                   device="cpu")
    X = torch.as_tensor(np.random.default_rng(7).random((H.shape[0], 3)))
    Y = pt.matmat(A, X)
    for j in range(3):
        assert torch.equal(Y[:, j], spmv.bws_spmv(A, X[:, j].contiguous()))
    np.testing.assert_allclose(
        Y.numpy(), np.stack([H.matvec(c) for c in X.numpy().T], axis=1),
        rtol=1e-14, atol=1e-12)


def test_pack_cache_hit_is_bit_equal(monkeypatch):
    monkeypatch.setattr(tbws, "_PACK_CACHE", {})
    H = pt.problems.fem_poisson_2d_unstructured(23, seed=1)
    pt.BwsMatrix.from_host_csr(H, device="cpu")
    assert len(tbws._PACK_CACHE) == 1
    # same structure, new values: a hit, packed as the JAX package packs
    H2 = pt.HostCSR(H.indptr, H.indices,
                    np.random.default_rng(8).random(H.nnz), H.shape)
    T = pt.BwsMatrix.from_host_csr(H2, device="cpu")
    assert len(tbws._PACK_CACHE) == 1
    J = JaxBws.from_host_csr(JaxCSR(H2.indptr, H2.indices, H2.data,
                                    H2.shape), _device=False)
    for f in ("delta", "data", "lidx", "base", "perm", "iperm"):
        assert np.array_equal(getattr(T, f).numpy(), np.asarray(getattr(J, f)))
    assert T.s_classes == J.s_classes and T.gt == J.gt
    # the cached tables are read-only: the CPU pack holds its own copies
    assert T.delta.numpy().flags.writeable
    # a new dtype or option is a new entry; the bound holds
    monkeypatch.setattr(tbws, "PACK_CACHE_SIZE", 2)
    pt.BwsMatrix.from_host_csr(H2, dtype=np.float64, device="cpu")
    pt.BwsMatrix.from_host_csr(H2, use_rcm=False, device="cpu")
    assert len(tbws._PACK_CACHE) == 2


def test_factories_refuse_a_block_of_right_hand_sides():
    _, Ht, B = _system("lap", 8)
    for f in (pt.PCG, pt.GMRES):
        with pytest.raises(ValueError, match="solve\\(A, B\\)"):
            f(device="cpu").make_solver().solve(Ht, B)


def test_block_lane_gmres_with_k_rhs_names_cg():
    H = pt.fd_vector_laplacian_2d(6, b=2, coupling=0.2)
    A = pt.BdiaMatrix.from_host_csr(H, 2, device="cpu")
    B = np.ones((H.shape[0], 2))
    with pytest.raises(ValueError, match='method="cg"'):
        pt.solve(A, B, method="gmres")
    assert pt.solve(A, B, method="cg", tau=1e-10).success


def test_zero_columns_refused():
    _, Ht, _ = _system("lap", 8)
    with pytest.raises(ValueError, match="zero columns"):
        pt.solve(Ht, np.zeros((Ht.shape[0], 0)), device="cpu")
