"""``solve(..., precision="mixed")`` of the port against the JAX package's,
tau = 1e-10, f64 inputs from ``default_rng``:

* the scalar route: CG + SA-AMG on fd_laplacian_2d(31), GMRES + ILUT on
  fd_convection_diffusion_2d(31) (the f64 FGMRES inner with the f32 ILUT
  apply, since a preconditioner turns ``hi_matvec`` on);
Gates: the same stop reason, iterations within ±1, f64 solutions within
1e-8 relative.  Also: the value fingerprint of the solver cache (an
in-place change of ``A.data`` forms anew) and its bound of eight entries,
and the HostCSR auto-route keeping the precision.  The block lane's
routes are in ``test_torch_mixed_block.py``.
"""
import importlib

import numpy as np
import pytest
import torch

import pysolvers_tpu as pst
from pysolvers_tpu.problems.laplacian import fd_convection_diffusion_2d as jcd
import pysolvers_tpu_torch as pt
from pysolvers_tpu_torch.core import StopReason

torch.set_num_threads(1)
# the module, not the function the package exports under the same name
tsolve = importlib.import_module("pysolvers_tpu_torch.solve")
TAU = 1e-10


def _agree(st, sj, tol=1e-8):
    assert st.reason == sj.reason == StopReason.CONVERGED
    assert abs(st.iters - sj.iters) <= 1
    x, xj = st.soln.numpy(), np.asarray(sj.soln)
    assert st.soln.dtype == torch.float64 and x.shape == xj.shape
    assert np.linalg.norm(x - xj) / np.linalg.norm(xj) <= tol


@pytest.mark.parametrize("case", ["cg_amg", "gmres_ilut"])
def test_scalar_route_matches_jax(case):
    if case == "cg_amg":
        Hj, Ht = (pst.problems.fd_laplacian_2d(31),
                  pt.problems.fd_laplacian_2d(31))
        kw = dict(precond="amg")
    else:
        Hj, Ht = jcd(31), pt.fd_convection_diffusion_2d(31)
        kw = {}
    b = Hj.matvec(np.random.default_rng(2).random(Hj.shape[0]))
    sj = pst.solve(Hj, b, tau=TAU, precision="mixed", **kw)
    st = pt.solve(Ht, b, tau=TAU, precision="mixed", device="cpu", **kw)
    _agree(st, sj)


def test_auto_route_keeps_the_precision(monkeypatch):
    """An all-"auto" CG call on a block-structured HostCSR of n >= 10,000
    goes to the block lane at mixed precision."""
    H = pt.fd_vector_laplacian_2d(60, b=3, coupling=0.2)
    b = H.matvec(np.random.default_rng(0).random(H.shape[0]))
    seen = []
    mixed = tsolve._solve_bdia_mixed
    monkeypatch.setattr(tsolve, "_solve_bdia_mixed",
                        lambda *a, **k: seen.append(1) or mixed(*a, **k))
    st = pt.solve(H, b, tau=TAU, precision="mixed", device="cpu",
                  maxiter=2000)
    assert seen and st.reason == StopReason.CONVERGED
    assert st.soln.dtype == torch.float64


def test_solver_cache_fingerprint():
    H = pt.problems.fd_laplacian_2d(15)
    b = H.matvec(np.random.default_rng(1).random(H.shape[0]))
    tsolve._MIXED_CACHE.clear()
    kw = dict(tau=TAU, method="cg", precision="mixed", device="cpu")
    st1 = pt.solve(H, b, **kw)
    (ent,) = tsolve._MIXED_CACHE.values()
    st2 = pt.solve(H, b, **kw)
    assert list(tsolve._MIXED_CACHE.values()) == [ent]       # reused
    np.testing.assert_array_equal(st1.soln.numpy(), st2.soln.numpy())
    H.data *= 2.0                                            # in place
    st3 = pt.solve(H, b, **kw)
    assert len(tsolve._MIXED_CACHE) == 2
    np.testing.assert_allclose(st3.soln.numpy(), 0.5 * st1.soln.numpy(),
                               rtol=1e-8)
    for m in range(3, 12):
        Hm = pt.problems.fd_laplacian_2d(m)
        pt.solve(Hm, np.ones(Hm.shape[0]), **kw)
    assert len(tsolve._MIXED_CACHE) <= 8
