"""The block lane of ``solve(..., precision="mixed")`` against the JAX
package's, tau = 1e-10, f64 inputs from ``default_rng``, on
fd_vector_laplacian_2d(16, b=3, coupling=0.2): one right-hand side with
"auto" (block-Jacobi: the f32 recurrence, K4's twin inside and in f64 as
the oracle, replacements every 48 steps), three with "auto"
(``cg_lockstep_rr``, K5's twin for the operator and block-Jacobi) and
"bcheb" (``ir_solve_multi``); and "bmg" on fd_vector_laplacian_2d(16, b=2)
(the JAX package's b hierarchies take ~15 s to compile).  Gates: the same
stop reason, iterations within ±1, f64 solutions within 1e-8 relative,
each column's host residual within tau.
"""
import numpy as np
import pytest
import torch

import pysolvers_tpu as pst
from pysolvers_tpu.problems.laplacian import fd_vector_laplacian_2d as jvec
from pysolvers_tpu.sparse.bdia import BdiaMatrix as JaxBdia
from pysolvers_tpu.sparse.host import HostCSR as JaxCSR
import pysolvers_tpu_torch as pt
from pysolvers_tpu_torch.core import StopReason
from pysolvers_tpu_torch.ops import spmv

torch.set_num_threads(1)
TAU = 1e-10


def _agree(st, sj, tol=1e-8):
    assert st.reason == sj.reason == StopReason.CONVERGED
    assert abs(st.iters - sj.iters) <= 1
    x, xj = st.soln.numpy(), np.asarray(sj.soln)
    assert st.soln.dtype == torch.float64 and x.shape == xj.shape
    assert np.linalg.norm(x - xj) / np.linalg.norm(xj) <= tol


def _block(m, b):
    Ht = pt.fd_vector_laplacian_2d(m, b=b, coupling=0.2)
    Hj = jvec(m, b=b, coupling=0.2)
    J = JaxBdia.from_host_csr(JaxCSR(Hj.indptr, Hj.indices, Hj.data,
                                     Hj.shape), b)
    T = pt.BdiaMatrix.from_host_csr(Ht, b, device="cpu")
    B = np.stack([Ht.matvec(np.random.default_rng(s).random(Ht.shape[0]))
                  for s in range(3)], axis=1)
    return J, T, B


@pytest.fixture(scope="module")
def block16():
    return _block(16, 3)


@pytest.mark.parametrize("precond,k", [("auto", 1), ("bmg", 1), ("auto", 3),
                                       ("bcheb", 3)])
def test_block_lane_matches_jax(block16, precond, k):
    J, T, B = block16 if precond != "bmg" else _block(16, 2)
    b = B[:, 0] if k == 1 else B
    sj = pst.solve(J, b, tau=TAU, precision="mixed", precond=precond,
                   maxiter=2000)
    k4, k5 = spmv.bdia_spmv_launches, spmv.bdia_spmm_launches
    st = pt.solve(T, b, tau=TAU, precision="mixed", precond=precond,
                  maxiter=2000)
    _agree(st, sj)
    # the CPU runs the twins: no kernel launch
    assert (spmv.bdia_spmv_launches, spmv.bdia_spmm_launches) == (k4, k5)
    if k > 1:
        for j in range(k):
            r = B[:, j] - T.to_host_csr().matvec(st.soln[:, j].numpy())
            assert np.linalg.norm(r) <= TAU * np.linalg.norm(B[:, j])
