"""The geometric-multigrid f32 route (``benchmarks/hbm_solve.py::run_solve``
at a small size) against the JAX package's: the f32 fine DIA table of
fd_laplacian_2d(31), the device-probed 3-level hierarchy built in f32
(Jacobi, its coarsest dense inverse included; the grid-kernel threshold
lowered so that the m = 15 and 31 levels are GridDiaMatrix, K6's twin
here), and ``cg_solve_rr(hi_matvec=False, maxiter=200, tau=1e-10)`` with
two V-cycles as the preconditioner and the f64 oracle (the matrix-free
stencil in JAX, the f64 grid table in the port).  Gates: every level and
the coarsest inverse are f32; the same stop reason, iterations within ±1,
x within 1e-6 relative and a host-checked ‖b − Ax‖ <= 1.01·tau‖b‖."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysolvers_tpu as pst
from pysolvers_tpu.linear import gmg_grid as jgg
from pysolvers_tpu.linear import krylov as jk
import pysolvers_tpu_torch as pt
from pysolvers_tpu_torch.core import StopReason
from pysolvers_tpu_torch.linear import gmg_grid as tgg
from pysolvers_tpu_torch.linear import krylov as tk
from pysolvers_tpu_torch.ops import grid_spmv
from pysolvers_tpu_torch.ops.grid_spmv import GridDiaMatrix

torch.set_num_threads(1)
M, LEVELS = 31, 3


def _jax_mv64(m):
    """hbm_solve.py's analytic f64 stencil apply."""
    s = np.float64((m + 1.0) ** 2)

    def mv(x):
        g = x.reshape(m, m)
        y = 4.0 * g
        y = y.at[:, 1:].add(-g[:, :-1])
        y = y.at[:, :-1].add(-g[:, 1:])
        y = y.at[1:, :].add(-g[:-1, :])
        y = y.at[:-1, :].add(-g[1:, :])
        return (s * y).reshape(-1)

    return mv


def test_gmg_f32_route_matches_jax(monkeypatch):
    monkeypatch.setattr(tgg, "GRID_KERNEL_MIN_M", 15)
    Hj, Ht = pst.problems.fd_laplacian_2d(M), pt.problems.fd_laplacian_2d(M)
    x_star = np.random.default_rng(0).random(Hj.shape[0])
    b = Hj.matvec(x_star)
    hj = jgg.build_grid_hierarchy_device(
        pst.DiaMatrix.from_host_csr(Hj, dtype=np.float32), LEVELS, (M, M),
        smoother="jacobi")
    vj = jgg.grid_vc_apply(2)
    Aj = hj.levels[-1].A_dev
    xj, sj, _ = jk.cg_solve_rr(
        lambda v: pst.matvec(Aj, v), jnp.asarray(b), mv_hi=_jax_mv64(M),
        maxiter=200, tau=1e-10, precond=lambda r: vj(hj, r).astype(r.dtype),
        hi_matvec=False)

    ht = tgg.build_grid_hierarchy_device(
        pt.DiaMatrix.from_host_csr(Ht, dtype=np.float32, device="cpu"),
        LEVELS, (M, M), smoother="jacobi")
    assert ht.A0_inv.dtype == torch.float32
    for L in ht.levels[1:]:
        assert L.A_dev.dtype == L.dinv.dtype == torch.float32
    assert [type(L.A_dev).__name__ for L in ht.levels[1:]] == [
        "GridDiaMatrix"] * 2                               # m = 15, 31
    G64 = GridDiaMatrix.from_dia_device(
        pt.DiaMatrix.from_host_csr(Ht, dtype=np.float64, device="cpu"),
        (M, M))
    vt = tgg.grid_vc_apply(2)
    At = ht.levels[-1].A_dev
    before = grid_spmv.grid_dia_spmv_launches
    xt, st, _ = tk.cg_solve_rr(
        lambda v: pt.matvec(At, v), torch.as_tensor(b),
        mv_hi=lambda v: pt.matvec(G64, v), maxiter=200, tau=1e-10,
        precond=lambda r: vt(ht, r), hi_matvec=False)
    assert grid_spmv.grid_dia_spmv_launches == before       # CPU: the twin
    assert st.reason == int(sj.reason) == StopReason.CONVERGED
    assert abs(st.k - int(sj.k)) <= 1
    assert xt.dtype == torch.float64
    xt = xt.numpy()
    assert (np.linalg.norm(xt - np.asarray(xj))
            <= 1e-6 * np.linalg.norm(np.asarray(xj)))
    assert (np.linalg.norm(b - Ht.matvec(xt))
            <= 1.01e-10 * np.linalg.norm(b))
