"""The slice as a whole: PCG + SA-AMG through the factory API and the
``solve()`` front end, port against the JAX package on the same seeded
problem (f64, tau = 1e-10): same stop reason, iterations within ±1,
solutions within 1e-6 relative.  The smoother is pinned where the CPU
default ("gs") differs from the accelerator's ("jacobi")."""
import numpy as np
import pytest
import torch

import pysolvers_tpu as pst
import pysolvers_tpu_torch as pt
from pysolvers_tpu_torch.ops import spmv

torch.set_num_threads(1)


def _rhs(m, seed):
    H = pt.problems.fd_laplacian_2d(m)
    return H.matvec(np.random.default_rng(seed).random(H.shape[0]))


def _agree(st, sj):
    assert st.success and sj.success
    assert st.reason == sj.reason
    assert abs(st.iters - sj.iters) <= 1
    xj = np.asarray(sj.soln)
    x = st.soln.numpy()
    assert np.linalg.norm(x - xj) / np.linalg.norm(xj) <= 1e-6


@pytest.mark.parametrize("smoother", ["jacobi", "gs"])
def test_pcg_amg_matches_jax(smoother):
    m = 48
    b = _rhs(m, 0)
    args = dict(maxiter=200, tau=1e-10)
    st = pt.PCG(pt.CommonSolverArgs(**args),
                precond=pt.AMG(num_iters=2, num_levels=3, smoother=smoother),
                device="cpu").make_solver().solve(
                    pt.problems.fd_laplacian_2d(m), b)
    sj = pst.PCG(pst.CommonSolverArgs(**args),
                 precond=pst.AMG(num_iters=2, num_levels=3,
                                 smoother=smoother)
                 ).make_solver().solve(pst.problems.fd_laplacian_2d(m), b)
    _agree(st, sj)
    assert st.soln.device.type == "cpu"


def test_solve_front_end_matches_jax():
    m = 40
    b = _rhs(m, 1)
    st = pt.solve(pt.problems.fd_laplacian_2d(m), b, precond="amg",
                  tau=1e-10, device="cpu")
    sj = pst.solve(pst.problems.fd_laplacian_2d(m), b, precond="amg",
                   tau=1e-10)
    _agree(st, sj)


def test_frozen_preconditioner_is_reused():
    H = pt.problems.fd_laplacian_2d(24)
    b = _rhs(24, 2)
    solver = pt.PCG(pt.CommonSolverArgs(tau=1e-10),
                    precond=pt.AMG(num_iters=1, num_levels=2),
                    device="cpu").make_solver()
    solver.freeze_matrix()
    solver.freeze_prec()
    st1 = solver.solve(H, b)
    prec = solver._formed_prec
    st2 = solver.solve(H, b)
    assert solver._formed_prec is prec
    assert st1.iters == st2.iters and st1.success
    np.testing.assert_array_equal(st1.soln.numpy(), st2.soln.numpy())


# precision="mixed" runs since slice 7 (tests/test_torch_mixed*.py), and
# solve(A, B) on a scalar HostCSR since slice 10
# (tests/test_torch_multi_rhs.py); the factories take one right-hand side
# and refuse a 2-D b with a ValueError that names solve(A, B)
UNPORTED = {
    "mesh": lambda H, b: pt.solve(H, b, mesh=object()),
    "pcg_mixed": lambda H, b: pt.PCG(
        precision="mixed", device="cpu").make_solver().solve(
            H, np.stack([b, b], axis=1)),
    "pcg_mesh": lambda H, b: pt.PCG(mesh=object()),
    "vcycle_bws_mesh": lambda H, b: pt.AMGVCycle(matrix_format="bws",
                                                 mesh=object()),
    "pcg_mixed_bws_pair": lambda H, b: pt.PCG(
        precision="mixed", precond=pt.AMG(matrix_format="bws"),
        device="cpu").make_solver().solve((H, pt.BwsMatrix.from_host_csr(
            H, use_rcm=False, device="cpu")), np.stack([b, b], axis=1)),
    "amg_galerkin_device": lambda H, b: pt.AMG(galerkin="device"),
    "vcycle_mesh": lambda H, b: pt.AMGVCycle(mesh=object()),
}
FACTORY_BLOCK_RHS = ("pcg_mixed", "pcg_mixed_bws_pair")


@pytest.mark.parametrize("route", sorted(UNPORTED))
def test_unported_routes_raise(route):
    H = pt.problems.fd_laplacian_2d(24)
    error, match = ((ValueError, "solve\\(A, B\\)")
                    if route in FACTORY_BLOCK_RHS
                    else (NotImplementedError, "ROADMAP slice"))
    with pytest.raises(error, match=match):
        UNPORTED[route](H, _rhs(24, 3))


@pytest.mark.parametrize("precision", ["native", "mixed"])
def test_block_rhs_solves_each_column(precision):
    """solve(A, B) solves each column as solve(A, b) does (within
    tau = 1e-10 in the host residual)."""
    H = pt.problems.fd_laplacian_2d(24)
    B = np.stack([_rhs(24, 3), _rhs(24, 4)], axis=1)
    st = pt.solve(H, B, tau=1e-10, precond="amg", precision=precision,
                  device="cpu")
    assert st.success and tuple(st.soln.shape) == B.shape
    for j in range(2):
        r = B[:, j] - H.matvec(st.soln[:, j].numpy())
        assert np.linalg.norm(r) <= 1e-9 * np.linalg.norm(B[:, j])


def test_cpu_path_launches_no_kernel():
    """On the CPU the wrapper runs the plain twin, never K1."""
    before = spmv.dia_spmv_launches
    st = pt.solve(pt.problems.fd_laplacian_2d(24), _rhs(24, 4),
                  precond="jacobi", device="cpu")
    assert st.success
    assert spmv.dia_spmv_launches == before
