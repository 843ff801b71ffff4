"""The block preconditioners and the block-DIA lane of ``solve()`` against
the JAX package, on the same seeded inputs, in f64.

* ``batched_inverse``, ``block_jacobi_bdia_matrix``, ``bdia_dof_subsystem``
  and the applies of block-Jacobi, block-Chebyshev and block-MG agree with
  the JAX package's within 1e-12 (relative; the same operations in the
  same order up to the einsum's and the V-cycle's summation order), the
  subsystem exactly.
* ``solve(BdiaMatrix, b)`` and ``solve(BdiaMatrix, B)``: the same stop
  reason, iterations within ±1 and solutions within 1e-8 relative of the
  JAX solve at tau = 1e-10; the lockstep column 0 agrees with the
  single-RHS solve.
* The HostCSR auto-route takes the block lane (K4's twin runs, no scalar
  AMG hierarchy is built) and ``detect_blocks=False`` keeps the scalar
  route; every invalid option raises and names what to pass instead.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysolvers_tpu as pst
from pysolvers_tpu.linear import block_precond as jbp
from pysolvers_tpu.sparse.bdia import BdiaMatrix as JaxBdia
from pysolvers_tpu.sparse.host import HostCSR as JaxCSR
import pysolvers_tpu_torch as pt
from pysolvers_tpu_torch import convert
from pysolvers_tpu_torch.core import StopReason
from pysolvers_tpu_torch.linear import amg as tamg
from pysolvers_tpu_torch.linear import block_precond as tbp
from pysolvers_tpu_torch.linear.krylov import cg_solve, cg_solve_multi_rows
from pysolvers_tpu_torch.ops import spmv
from pysolvers_tpu_torch.sparse.bdia import BdiaMatrix
from pysolvers_tpu_torch.sparse.bws import BwsCsrMatrix

torch.set_num_threads(1)
# the module, not the function the package exports under the same name
tsolve = importlib.import_module("pysolvers_tpu_torch.solve")

TOL = 1e-12


def _pair(m, b, coupling=0.2):
    H = pt.fd_vector_laplacian_2d(m, b=b, coupling=coupling)
    A = BdiaMatrix.from_host_csr(H, b, device="cpu")
    J = JaxBdia.from_host_csr(JaxCSR(H.indptr, H.indices, H.data, H.shape), b)
    return H, A, J


def _random_pair(nb, b, seed):
    """Random nonsymmetric, diagonally dominant blocks on offsets
    (-3, 0, 2): the diagonal blocks are nonsymmetric, so a transposed
    inverse fails."""
    rng = np.random.default_rng(seed)
    offsets = (-3, 0, 2)
    planes = rng.standard_normal((3 * b, b, nb))
    planes[b:2 * b] += 4.0 * b * np.eye(b)[:, :, None]   # planes[q, p, i]
    A = convert.bdia_from_arrays(planes, offsets, (nb * b, nb * b), b,
                                 device="cpu")
    J = JaxBdia(jnp.asarray(planes), offsets, (nb * b, nb * b), b)
    return A, J, rng


def _rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return float(np.linalg.norm(a - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("ridge", [0.0, 0.5])
def test_batched_inverse_matches_jax(ridge):
    rng = np.random.default_rng(0)
    Bs = rng.standard_normal((40, 4, 4)) + 6.0 * np.eye(4)
    got = tbp.batched_inverse(torch.from_numpy(Bs), ridge=ridge).numpy()
    want = np.asarray(jbp.batched_inverse(jnp.asarray(Bs), ridge=ridge))
    assert _rel(got, want) <= TOL
    eye = np.eye(4)
    np.testing.assert_allclose((Bs + ridge * eye) @ got,
                               np.broadcast_to(eye, Bs.shape), atol=1e-12)


def test_block_jacobi_matrix_matches_jax_and_transposes():
    A, J, rng = _random_pair(37, 3, 1)
    M = tbp.block_jacobi_bdia_matrix(A)
    MJ = jbp.block_jacobi_bdia_matrix(J)
    assert M.offsets == MJ.offsets == (0,) and M.shape == MJ.shape
    assert M.nb_pad == MJ.nb_pad
    assert _rel(M.planes.numpy(), MJ.planes) <= TOL
    # applied as a block-DIA operator it is blockdiag(D_i)^{-1}
    v = rng.standard_normal(A.n_rows)
    y = spmv.bdia_spmv(M, torch.from_numpy(v)).numpy().reshape(3, -1)
    D = A.diag_blocks().numpy()                   # [i, p, q]
    want = np.linalg.solve(D, v.reshape(3, -1).T[:, :, None])[:, :, 0].T
    np.testing.assert_allclose(y, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("p", [0, 2])
def test_dof_subsystem_is_exact(p):
    _, A, J = _pair(11, 3)
    S, SJ = tbp.bdia_dof_subsystem(A, p), jbp.bdia_dof_subsystem(J, p)
    assert S.shape == SJ.shape
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(S, f), getattr(SJ, f))


PRECONDS = {
    "bjacobi": (tbp.BlockJacobiBdiaPreconditionerType,
                jbp.BlockJacobiBdiaPreconditionerType),
    "bcheb": (tbp.BlockChebyshevBdiaPreconditionerType,
              jbp.BlockChebyshevBdiaPreconditionerType),
    "bmg": (tbp.BlockMGBdiaPreconditionerType,
            jbp.BlockMGBdiaPreconditionerType),
}


@pytest.mark.parametrize("name", sorted(PRECONDS))
def test_precond_apply_matches_jax(name):
    _, A, J = _pair(14, 3)
    ours, theirs = PRECONDS[name]
    v = np.random.default_rng(3).standard_normal(A.n_rows)
    got = ours().form(A_dev=A).apply_any(torch.from_numpy(v)).numpy()
    want = theirs().form(A_dev=J).apply_any(jnp.asarray(v))
    assert got.shape == v.shape
    assert _rel(got, want) <= TOL


def test_bmg_takes_the_f32_bws_levels():
    H = pt.fd_vector_laplacian_2d(48, b=2)     # 2304 rows per dof
    A = BdiaMatrix.from_host_csr(H, 2, dtype=np.float32, device="cpu")
    prec = tbp.BlockMGBdiaPreconditionerType().form(A_dev=A)
    assert len(prec.state) == 2
    assert isinstance(prec.state[0].levels[-1].A_dev, BwsCsrMatrix)
    y = prec.apply_any(torch.ones(A.n_rows, dtype=torch.float32))
    assert y.dtype == torch.float32 and bool(torch.isfinite(y).all())


def _agree(st, sj, rel=1e-8):
    assert st.reason == sj.reason and st.success
    assert abs(st.iters - int(sj.iters)) <= 1
    assert _rel(st.soln.numpy(), sj.soln) <= rel


@pytest.mark.parametrize("precond", ["auto", "none", "bcheb", "bmg"])
def test_solve_matches_jax(precond):
    H, A, J = _pair(16, 3)
    b = H.matvec(np.random.default_rng(4).random(H.shape[0]))
    st = pt.solve(A, b, tau=1e-10, precond=precond)
    sj = pst.solve(J, b, tau=1e-10, precond=precond)
    assert st.soln.shape == (H.shape[0],)
    _agree(st, sj)
    assert st.resid_history is not None


@pytest.mark.parametrize("precond", ["bjacobi", "bmg"])
def test_multi_rhs_solve_matches_jax(precond):
    H, A, J = _pair(10, 5)
    rng = np.random.default_rng(6)
    X = rng.random((H.shape[0], 3))
    B = np.stack([H.matvec(X[:, j]) for j in range(3)], axis=1)
    st = pt.solve(A, B, tau=1e-10, precond=precond)
    sj = pst.solve(J, B, tau=1e-10, precond=precond)
    assert st.soln.shape == (H.shape[0], 3)
    _agree(st, sj)
    for j in range(3):
        assert _rel(st.soln[:, j].numpy(), np.asarray(sj.soln)[:, j]) <= 1e-8
    s0 = pt.solve(A, B[:, 0], tau=1e-10, precond=precond)
    assert _rel(st.soln[:, 0].numpy(), s0.soln.numpy()) <= 1e-8


def test_multi_rhs_bjacobi_goes_through_k5_twin(monkeypatch):
    H, A, _ = _pair(8, 2)
    calls = {"spmm": 0, "spmv": 0}
    real_mm, real_mv = spmv.bdia_spmm_torch, spmv.bdia_spmv_torch

    def spy_mm(*a):
        calls["spmm"] += 1
        return real_mm(*a)

    def spy_mv(*a):
        calls["spmv"] += 1
        return real_mv(*a)

    monkeypatch.setattr(spmv, "bdia_spmm_torch", spy_mm)
    monkeypatch.setattr(spmv, "bdia_spmv_torch", spy_mv)
    B = np.random.default_rng(0).random((H.shape[0], 2))
    st = pt.solve(A, B, tau=1e-10)
    assert st.success
    # operator and preconditioner each once per iteration, plus the start
    assert calls["spmm"] >= 2 * st.iters + 1 and calls["spmv"] == 0


def test_lockstep_cg_per_row_semantics():
    H, A, _ = _pair(10, 2)
    rng = np.random.default_rng(8)
    b0 = H.matvec(rng.random(H.shape[0]))
    # row 1 is zero (converged at 0 iterations), row 2 a scaled row 0
    B = torch.from_numpy(np.stack([b0, 0 * b0, 1e3 * b0]))
    Bp = torch.stack([A.to_planar(r) for r in B])
    X, st, _ = cg_solve_multi_rows(lambda V: spmv.bdia_spmm_rows(A, V), Bp,
                                   maxiter=500, tau=1e-10)
    x0, st0, _ = cg_solve(lambda v: spmv.bdia_spmv(A, v), Bp[0],
                          maxiter=500, tau=1e-10)
    assert st.k.tolist() == [st0.k, 0, st0.k]
    assert st.reason.tolist() == [StopReason.CONVERGED] * 3
    np.testing.assert_allclose(X[0].numpy(), x0.numpy(), rtol=1e-12,
                               atol=1e-14)
    assert float(X[1].abs().max()) == 0.0
    _, stm, _ = cg_solve_multi_rows(lambda V: spmv.bdia_spmm_rows(A, V),
                                    Bp[:1], maxiter=3, tau=1e-10)
    assert stm.reason.tolist() == [StopReason.MAXITER] and stm.k.tolist() == [3]


def test_auto_route_from_host_csr(monkeypatch):
    """An all-"auto" CG solve of a large HostCSR with 5×5 blocks packs it
    and takes the block lane: K4's twin runs and no scalar SA hierarchy is
    built; the result is the hand-packed solve's."""
    H = pt.fd_vector_laplacian_2d(46, b=5, coupling=0.2)      # n = 10580
    assert H.shape[0] >= 10_000
    b = H.matvec(np.random.default_rng(3).random(H.shape[0]))
    calls = {"k4_twin": 0}
    real = spmv.bdia_spmv_torch

    def spy(*a):
        calls["k4_twin"] += 1
        return real(*a)

    monkeypatch.setattr(spmv, "bdia_spmv_torch", spy)
    monkeypatch.setattr(tamg, "build_sa_hierarchy", lambda *a, **k: (
        _ for _ in ()).throw(AssertionError("scalar AMG hierarchy")))
    st = pt.solve(H, b, tau=1e-8, maxiter=4000, device="cpu")
    assert st.success and calls["k4_twin"] > st.iters
    hand = pt.solve(BdiaMatrix.from_host_csr(H, 5, device="cpu"), b,
                    tau=1e-8, maxiter=4000)
    np.testing.assert_array_equal(st.soln.numpy(), hand.soln.numpy())
    x = st.soln.numpy()
    assert np.linalg.norm(b - H.matvec(x)) <= 1e-8 * np.linalg.norm(b) * 1.01


def test_detect_blocks_false_keeps_the_scalar_route(monkeypatch):
    H = pt.fd_vector_laplacian_2d(64, b=5, coupling=0.2)      # n = 20480
    monkeypatch.setattr(tsolve, "_solve_bdia", lambda *a, **k: (
        _ for _ in ()).throw(AssertionError("block lane")))
    resolved = []
    real = tsolve._precond_type

    def spy(*a):
        resolved.append(real(*a))
        raise RuntimeError("scalar route reached")

    monkeypatch.setattr(tsolve, "_precond_type", spy)
    with pytest.raises(RuntimeError, match="scalar route"):
        pt.solve(H, np.ones(H.shape[0]), detect_blocks=False, device="cpu")
    assert isinstance(resolved[0], tamg.AMGPreconditionerType)


def test_precond_cache_reuses_and_sees_in_place_updates():
    H, A, _ = _pair(10, 2)
    b = H.matvec(np.random.default_rng(1).random(H.shape[0]))
    # the apply is a bound method of the one cached Preconditioner
    p1 = tsolve._bdia_precond(A, "bjacobi")
    assert tsolve._bdia_precond(A, "auto") == p1
    st1 = pt.solve(A, b, tau=1e-10)
    with torch.no_grad():
        A.planes.mul_(2.0)
    assert tsolve._bdia_precond(A, "bjacobi") != p1
    st2 = pt.solve(A, b, tau=1e-10)
    np.testing.assert_allclose(st2.soln.numpy(), 0.5 * st1.soln.numpy(),
                               rtol=1e-8, atol=1e-12)
    for m in range(3, 15):
        tsolve._bdia_precond(_pair(m, 2)[1], "bjacobi")
    assert len(tsolve._BDIA_SOLVE_CACHE) <= 8


# (solve() arguments, right-hand sides: None for one, else k columns, the
# error and its message); single-RHS GMRES and IC are ported
# (tests/test_torch_gmres.py), and precision="mixed"
# (tests/test_torch_mixed_block.py); GMRES with k columns is refused (the
# JAX package runs CG there) and names method="cg"; mesh= is ported
# (tests/test_torch_mesh_factory.py) and takes only a port Mesh
INVALID = {
    "mixed": (dict(precision="mixed", mesh=object()), None,
              TypeError, "make_mesh"),
    "gmres": (dict(method="gmres"), 2, ValueError, 'method="cg"'),
    "ic": (dict(precond="ic", precision="mixed", mesh=object()), 2,
           TypeError, "make_mesh"),
    "mesh": (dict(mesh=object()), None, TypeError, "make_mesh"),
}


@pytest.mark.parametrize("route", sorted(INVALID))
def test_invalid_block_options_raise(route):
    H, A, _ = _pair(6, 2)
    kwargs, k, error, match = INVALID[route]
    b = np.ones(H.shape[0]) if k is None else np.ones((H.shape[0], k))
    with pytest.raises(error, match=match):
        pt.solve(A, b, **kwargs)


def test_bad_block_arguments_raise():
    H, A, _ = _pair(6, 2)
    with pytest.raises(ValueError, match="precond"):
        pt.solve(A, np.ones(H.shape[0]), precond="amg")
    with pytest.raises(ValueError, match="shape"):
        pt.solve(A, np.ones(H.shape[0] + 1))
    with pytest.raises(ValueError, match="shape"):
        pt.solve(A, np.ones((H.shape[0], 0)))
