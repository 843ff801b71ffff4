"""The port's SA-AMG cycle against the JAX package's (f64).

One V-cycle on a JAX DeviceHierarchy carried across by convert.py, and on
the hierarchy the port builds itself, must agree with the JAX cycle to
1e-12 relative: the operators are the same bits, and only the summation
order inside the SpMVs, triangular solves and the coarse matmul differs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysolvers_tpu as pst
import pysolvers_tpu.linear.amg as jamg
import pysolvers_tpu.sparse.device as jdev
from pysolvers_tpu.sparse.bws import BwsMatrix as JaxBws
import pysolvers_tpu_torch as pt
import pysolvers_tpu_torch.linear.amg as tamg
from pysolvers_tpu_torch import convert

torch.set_num_threads(1)


def _op_arrays(op):
    if op is None:
        return None
    if isinstance(op, jdev.DiaTiled):
        op = op.to_dia()
    if isinstance(op, jdev.DiaMatrix):
        return dict(diags=np.asarray(op.diags), offsets=op.offsets,
                    shape=op.shape)
    if isinstance(op, JaxBws):
        return dict(
            {f: np.asarray(getattr(op, f)) for f in
             ("delta", "data", "lidx", "perm", "iperm", "base")},
            shape=op.shape, win_blocks=op.win_blocks,
            group_rows=op.group_rows, s_classes=op.s_classes, gt=op.gt,
            fast_select=op.fast_select)
    return dict(data=np.asarray(op.data), cols=np.asarray(op.cols),
                shape=op.shape, n_cols_pad=op.n_cols_pad)


def _plan_arrays(plan):
    if plan is None:
        return None
    if isinstance(plan, tuple):
        return tuple(_plan_arrays(p) for p in plan)
    return dict(ell_data=np.asarray(plan.ell_data),
                ell_cols=np.asarray(plan.ell_cols),
                diag=np.asarray(plan.diag), levels=np.asarray(plan.levels),
                lower=plan.lower)


def dump_hierarchy(h):
    """A JAX DeviceHierarchy as numpy leaves, for convert.py."""
    levels = [dict(A=_op_arrays(L.A_dev), P=_op_arrays(L.P_dev),
                   R=_op_arrays(L.R_dev),
                   dinv=None if L.dinv is None else np.asarray(L.dinv),
                   gs_plan=_plan_arrays(L.gs_plan),
                   cheb=None if L.cheb is None
                   else tuple(float(c) for c in L.cheb)) for L in h.levels]
    return dict(levels=levels, A0_inv=np.asarray(h.A0_inv),
                smoother=h.smoother, nu_pre=h.nu_pre, nu_post=h.nu_post)


@pytest.fixture(scope="module")
def problem():
    m = 48
    Hj, Ht = pst.problems.fd_laplacian_2d(m), pt.problems.fd_laplacian_2d(m)
    rng = np.random.default_rng(0)
    return Hj, Ht, rng.standard_normal(m * m), rng.standard_normal(m * m)


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("smoother", ["jacobi", "gs", "sgs", "chebyshev"])
@pytest.mark.parametrize("built_by", ["converted", "port"])
def test_v_cycle_matches_jax(problem, smoother, built_by):
    Hj, Ht, f, x0 = problem
    hj = jamg.build_device_hierarchy(jamg.build_sa_hierarchy(Hj, 3),
                                     smoother)
    y_ref = np.asarray(jamg.v_cycle(hj, jnp.asarray(f), jnp.asarray(x0)))
    if built_by == "converted":
        ht = convert.hierarchy_from_arrays(device="cpu",
                                           **dump_hierarchy(hj))
    else:
        ht = tamg.build_device_hierarchy(tamg.build_sa_hierarchy(Ht, 3),
                                         smoother, device="cpu")
    assert ht.n_levels == hj.n_levels == 3
    assert ht.smoother == smoother
    y = tamg.v_cycle(ht, torch.from_numpy(f), torch.from_numpy(x0)).numpy()
    assert _rel(y, y_ref) <= 1e-12


def test_hierarchy_formats_match_jax(problem):
    """The port packs the same level formats (DIA where banded) as JAX."""
    Hj, Ht, _, _ = problem
    hj = jamg.build_device_hierarchy(jamg.build_sa_hierarchy(Hj, 3), "gs")
    ht = tamg.build_device_hierarchy(tamg.build_sa_hierarchy(Ht, 3), "gs",
                                     device="cpu")
    for Lj, Lt in zip(hj.levels[1:], ht.levels[1:]):
        for opj, opt in ((Lj.A_dev, Lt.A_dev), (Lj.P_dev, Lt.P_dev),
                         (Lj.R_dev, Lt.R_dev)):
            assert type(opt).__name__ == type(opj).__name__
            assert tuple(opt.shape) == tuple(opj.shape)
    np.testing.assert_allclose(ht.A0_inv.numpy(), np.asarray(hj.A0_inv),
                               rtol=1e-13, atol=0)


def test_auto_smoother_on_cpu_is_gs(problem):
    _, Ht, _, _ = problem
    h = tamg.build_device_hierarchy(tamg.build_sa_hierarchy(Ht, 2),
                                    device="cpu")
    assert h.smoother == "gs" and h.device.type == "cpu"


def test_amg_vcycle_solver_matches_jax(problem):
    Hj, Ht, f, _ = problem
    sj = pst.AMGVCycle(pst.CommonSolverArgs(maxiter=100, tau=1e-8),
                       num_levels=3, smoother="gs").make_solver().solve(Hj, f)
    st = pt.AMGVCycle(pt.CommonSolverArgs(maxiter=100, tau=1e-8),
                      num_levels=3, smoother="gs",
                      device="cpu").make_solver().solve(Ht, f)
    assert st.success and st.reason == sj.reason
    assert abs(st.iters - sj.iters) <= 1
    assert _rel(st.soln.numpy(), np.asarray(sj.soln)) <= 1e-6
