"""The port's operator algebra (``linear/operator.py``) against the JAX
package on the same seeded inputs (f64): sums, differences, scalings,
compositions and transposes within 1e-14 relative; inverses (GMRES by
default, or a solver factory through the matrix-free adapter) within 1e-8
relative of the JAX inverse and solving to 1e-10."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysolvers_tpu as pst
import pysolvers_tpu_torch as pt
from pysolvers_tpu.linear.operator import LinearOperator as JOp
from pysolvers_tpu_torch.linear.operator import LinearOperator, _FnMatrix

torch.set_num_threads(1)


def _ops(m=8):
    H = pt.fd_convection_diffusion_2d(m)
    Hj = pst.problems.laplacian.fd_convection_diffusion_2d(m)
    L = pt.problems.fd_laplacian_2d(m)
    Lj = pst.problems.fd_laplacian_2d(m)
    ops_t = (LinearOperator.from_matrix(pt.DiaMatrix.from_host_csr(
                 H, device="cpu")),
             LinearOperator.from_matrix(pt.DiaMatrix.from_host_csr(
                 L, device="cpu")))
    ops_j = (JOp.from_matrix(pst.DiaMatrix.from_host_csr(Hj)),
             JOp.from_matrix(pst.DiaMatrix.from_host_csr(Lj)))
    v = np.random.default_rng(9).standard_normal(m * m)
    return ops_t, ops_j, v


def _rel(x, y):
    x, y = np.asarray(x), np.asarray(y)
    return float(np.linalg.norm(x - y) / np.linalg.norm(y))


ALGEBRA = {
    "add": lambda A, B: A + B,
    "sub": lambda A, B: A - B,
    "scale": lambda A, B: 2.5 * A,
    "rscale": lambda A, B: A * -0.5,
    "neg": lambda A, B: -A,
    "compose": lambda A, B: A @ B,
    "mixed": lambda A, B: (A + 3.0 * B) @ (A - B),
}


@pytest.mark.parametrize("expr", sorted(ALGEBRA))
def test_algebra_matches_jax(expr):
    (A, B), (Aj, Bj), v = _ops()
    yt = ALGEBRA[expr](A, B)(torch.from_numpy(v))
    yj = ALGEBRA[expr](Aj, Bj)(jnp.asarray(v))
    assert ALGEBRA[expr](A, B).shape == (64, 64)
    assert _rel(yt.numpy(), yj) <= 1e-14


def test_transpose_identity_and_errors():
    (A, B), _, v = _ops()
    H = pt.fd_convection_diffusion_2d(8)
    Ht = H.transpose()
    op = LinearOperator(
        H.shape, lambda x: torch.from_numpy(H.matvec(x.numpy())),
        lambda x: torch.from_numpy(Ht.matvec(x.numpy())))
    x = torch.from_numpy(v)
    np.testing.assert_allclose(op.T(x).numpy(), Ht.matvec(v), rtol=1e-15)
    assert op.T.T(x).equal(op(x)) and op.matvec(x).equal(op(x))
    assert LinearOperator.identity(64)(x) is x
    with pytest.raises(NotImplementedError, match="transpose"):
        A.T
    with pytest.raises(TypeError, match="composition"):
        A * B
    rect = LinearOperator((64, 10), lambda x: x)
    with pytest.raises(ValueError, match="mismatch"):
        A + rect
    with pytest.raises(ValueError, match="mismatch"):
        rect @ A
    with pytest.raises(ValueError, match="non-square"):
        rect.inverse()


def test_default_inverse_matches_jax():
    (A, _), (Aj, _), v = _ops()
    xt = A.inverse()(torch.from_numpy(v))
    xj = Aj.inverse()(jnp.asarray(v))
    assert _rel(xt.numpy(), xj) <= 1e-8
    assert _rel(A(xt).numpy(), v) <= 1e-10
    singular = LinearOperator((4, 4), lambda x: torch.zeros_like(x))
    with pytest.raises(RuntimeError, match="inverse apply failed"):
        singular.inverse()(torch.ones(4, dtype=torch.float64))


def test_factory_inverse_through_the_matrix_free_adapter():
    """A solver factory inverts the operator through ``_FnMatrix``:
    ``as_device_matrix`` passes it through and ``matvec`` applies it."""
    (A, B), _, v = _ops()
    gm = pt.GMRES(pt.CommonSolverArgs(maxiter=200, tau=1e-12),
                  device="cpu")
    inv = (A + B).inverse(gm)
    x = inv(torch.from_numpy(v))
    assert _rel((A + B)(x).numpy(), v) <= 1e-10
    fn = _FnMatrix(A)
    host, dev = pt.as_device_matrix(fn)
    assert host is None and dev is fn
    assert pt.matvec(fn, torch.from_numpy(v)).equal(A(torch.from_numpy(v)))
    weak = pt.GMRES(pt.CommonSolverArgs(maxiter=2, tau=1e-12), device="cpu")
    with pytest.raises(RuntimeError, match="inverse apply failed"):
        A.inverse(weak)(torch.from_numpy(v))
