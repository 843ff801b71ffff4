"""The port's unstructured problem generators (``problems/fem.py``, a numpy
copy) give the JAX package's matrices bit for bit."""
import numpy as np
import pytest

from pysolvers_tpu.problems import fem as jfem
from pysolvers_tpu_torch import problems as tproblems


def _same(Hj, Ht):
    assert Ht.shape == Hj.shape
    for f in ("indptr", "indices", "data"):
        a, b = getattr(Hj, f), getattr(Ht, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("kw", [
    dict(m=8, seed=5),
    dict(m=17, seed=3),
    dict(m=12, seed=0, jitter=0.0, coeff=False, shuffle=False),
    dict(m=10, seed=1, dtype=np.float32),
], ids=["m8", "m17", "structured", "f32"])
def test_fem_poisson_matches_jax(kw):
    _same(jfem.fem_poisson_2d_unstructured(**kw),
          tproblems.fem_poisson_2d_unstructured(**kw))


@pytest.mark.parametrize("kw", [dict(n=500, seed=1), dict(n=1200, k=8,
                                                            seed=4)],
                         ids=["n500", "n1200_k8"])
def test_graph_laplacian_rgg_matches_jax(kw):
    _same(jfem.graph_laplacian_rgg(**kw), tproblems.graph_laplacian_rgg(**kw))


def test_fem_is_spd_and_unstructured():
    A = tproblems.fem_poisson_2d_unstructured(12, seed=2)
    Ad = A.to_dense()
    assert np.abs(Ad - Ad.T).max() == 0.0
    assert np.linalg.eigvalsh(Ad).min() > 0
    nnz = A.row_nnz()
    assert nnz.min() < nnz.max()
