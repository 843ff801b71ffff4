"""The unstructured (BWS) lane as a whole, port against the JAX package, on
the RCM-reordered ``fem_poisson_2d_unstructured(m, seed=3)`` — the
pipeline of ``benchmarks/unstructured_amg.py`` at test size:

(a) f32: PCG + AMG(matrix_format="bws") with a (host, BwsMatrix) pair in
    both packages (the JAX kernels in interpret mode), tau = 1e-5: same
    stop reason, iterations within ±1, solutions within 1e-4 relative
    (f32 rounding in different summation orders, carried through the
    iterations);
(b) f64: the port's BWS route against the JAX package's f64 route with
    matrix_format="auto" (the same hierarchy mathematics in ELL), tau =
    1e-10: iterations within ±1, solutions within 1e-6 relative;
(c) the caller's fine pack is the hierarchy's fine operator;
(d) a JAX BWS hierarchy carried across by ``convert`` (and the port's own
    BWS hierarchy) give the JAX ``v_cycle`` within 1e-5 relative in f32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysolvers_tpu as pst
import pysolvers_tpu.linear.amg as jamg
from pysolvers_tpu.sparse.bws import BwsMatrix as JaxBws
import pysolvers_tpu_torch as pt
import pysolvers_tpu_torch.linear.amg as tamg
from pysolvers_tpu_torch import convert

from test_torch_amg import dump_hierarchy

torch.set_num_threads(1)


def _problem(m):
    """RCM-reordered FEM matrix (port and JAX HostCSR), x* and b = A x*."""
    A = pt.problems.fem_poisson_2d_unstructured(m, seed=3)
    Ap = A.permute_symmetric(pt.BwsMatrix._rcm_perm(A))
    x = np.random.default_rng(7).normal(size=Ap.shape[0])
    return Ap, x, Ap.matvec(x)


def _cast(H, dtype, pkg):
    return pkg.HostCSR(H.indptr, H.indices, H.data.astype(dtype), H.shape)


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _bws_pcg(pkg, H, A_dev, b, tau, smoother, **kw):
    amg = pkg.AMG(num_iters=2, num_levels=3, galerkin="host",
                  matrix_format="bws", smoother=smoother)
    solver = pkg.PCG(pkg.CommonSolverArgs(maxiter=500, tau=tau),
                     precond=amg, **kw).make_solver()
    return solver, solver.solve((H, A_dev), b)


def _agree(st, sj, tol):
    assert st.success and sj.success
    assert st.reason == sj.reason
    assert abs(st.iters - sj.iters) <= 1
    assert _rel(st.soln.numpy(), np.asarray(sj.soln)) <= tol


def test_pcg_bws_f32_matches_jax():
    Ap, _, b = _problem(46)
    Ht, Hj = _cast(Ap, np.float32, pt), _cast(Ap, np.float32, pst)
    b32 = b.astype(np.float32)
    At = pt.BwsMatrix.from_host_csr(Ht, dtype=np.float32, use_rcm=False,
                                    device="cpu")
    Aj = JaxBws.from_host_csr(Hj, dtype=np.float32, use_rcm=False)
    _, st = _bws_pcg(pt, Ht, At, b32, 1e-5, "jacobi", device="cpu")
    _, sj = _bws_pcg(pst, Hj, Aj, b32, 1e-5, "jacobi")
    assert st.soln.dtype == torch.float32
    _agree(st, sj, 1e-4)


@pytest.mark.parametrize("smoother", ["jacobi", "gs"])
def test_pcg_bws_f64_matches_jax_auto(smoother):
    Ap, x_star, b = _problem(60)
    A_bws = pt.BwsMatrix.from_host_csr(Ap, dtype=np.float64, use_rcm=False,
                                       device="cpu")
    solver, st = _bws_pcg(pt, Ap, A_bws, b, 1e-10, smoother, device="cpu")
    amg = pst.AMG(num_iters=2, num_levels=3, galerkin="host",
                  smoother=smoother)
    sj = pst.PCG(pst.CommonSolverArgs(maxiter=500, tau=1e-10),
                 precond=amg).make_solver().solve(_cast(Ap, np.float64, pst),
                                                  b)
    _agree(st, sj, 1e-6)
    x = st.soln.numpy()
    assert np.linalg.norm(b - Ap.matvec(x)) <= 1.01e-10 * np.linalg.norm(b)
    # (c) the caller's pack is the fine operator, every operator of at
    # least 2000 rows or columns is BWS, and the smaller ones are not
    h = solver._formed_prec.state
    assert h.levels[-1].A_dev is A_bws
    for L in h.levels[1:]:
        for op in (L.A_dev, L.P_dev, L.R_dev):
            assert isinstance(op, pt.BwsMatrix) == (max(op.shape) >= 2000)


def test_amg_vcycle_solver_bws_matches_auto():
    """The stationary AMG solver threads matrix_format through."""
    Ap, _, b = _problem(50)

    def run(fmt):
        return pt.AMGVCycle(pt.CommonSolverArgs(maxiter=200, tau=1e-8),
                            num_levels=3, smoother="jacobi",
                            matrix_format=fmt,
                            device="cpu").make_solver().solve(Ap, b)

    st, ref = run("bws"), run("auto")
    assert st.success and st.iters == ref.iters
    assert _rel(st.soln.numpy(), ref.soln.numpy()) <= 1e-10


def test_bws_hierarchy_matches_ell_hierarchy_f64():
    """The BWS and ELL level formats carry the same operators: one f64
    V-cycle agrees to summation order."""
    Ap, _, _ = _problem(50)
    mlh = tamg.build_sa_hierarchy(Ap, 3)
    h_bws = tamg.build_device_hierarchy(mlh, "jacobi", device="cpu",
                                        matrix_format="bws")
    h_ell = tamg.build_device_hierarchy(mlh, "jacobi", device="cpu")
    assert isinstance(h_bws.levels[-1].A_dev, pt.BwsMatrix)
    assert isinstance(h_ell.levels[-1].A_dev, pt.EllMatrix)
    rng = np.random.default_rng(1)
    f = torch.from_numpy(rng.standard_normal(Ap.shape[0]))
    x0 = torch.from_numpy(rng.standard_normal(Ap.shape[0]))
    y = tamg.v_cycle(h_bws, f, x0).numpy()
    y_ref = tamg.v_cycle(h_ell, f, x0).numpy()
    assert _rel(y, y_ref) <= 1e-12


def test_permuted_pack_is_refused():
    Ap, _, b = _problem(46)
    A_rcm = pt.BwsMatrix.from_host_csr(Ap, dtype=np.float64, use_rcm=True,
                                       device="cpu")
    assert not np.array_equal(A_rcm.perm.numpy(), np.arange(Ap.shape[0]))
    with pytest.raises(ValueError, match="use_rcm=False"):
        _bws_pcg(pt, Ap, A_rcm, b, 1e-10, "jacobi", device="cpu")


@pytest.mark.parametrize("built_by", ["converted", "port"])
def test_v_cycle_matches_jax_bws_hierarchy(built_by):
    Ap, _, _ = _problem(46)
    mlh_j = jamg.build_sa_hierarchy(_cast(Ap, np.float32, pst), 3)
    hj = jamg.build_device_hierarchy(mlh_j, "jacobi", dtype=np.float32,
                                     matrix_format="bws")
    assert isinstance(hj.levels[-1].A_dev, JaxBws)
    if built_by == "converted":
        ht = convert.hierarchy_from_arrays(device="cpu",
                                           **dump_hierarchy(hj))
    else:
        ht = tamg.build_device_hierarchy(
            tamg.build_sa_hierarchy(_cast(Ap, np.float32, pt), 3), "jacobi",
            dtype=np.float32, device="cpu", matrix_format="bws")
    for Lj, Lt in zip(hj.levels[1:], ht.levels[1:]):
        for opj, opt in ((Lj.A_dev, Lt.A_dev), (Lj.P_dev, Lt.P_dev),
                         (Lj.R_dev, Lt.R_dev)):
            assert type(opt).__name__ == type(opj).__name__
    rng = np.random.default_rng(0)
    f = rng.standard_normal(Ap.shape[0]).astype(np.float32)
    x0 = rng.standard_normal(Ap.shape[0]).astype(np.float32)
    y_ref = np.asarray(jamg.v_cycle(hj, jnp.asarray(f), jnp.asarray(x0)))
    y = tamg.v_cycle(ht, torch.from_numpy(f), torch.from_numpy(x0)).numpy()
    assert _rel(y, y_ref) <= 1e-5
