"""The port's block-DIA pack and the twins of kernels K4/K5 against the JAX
package's.

* ``fd_vector_laplacian_2d`` and ``BdiaMatrix.from_host_csr`` (planes,
  offsets, both ``row_tile`` regimes, a random nonsymmetric block-banded
  matrix) must give the JAX package's arrays bit for bit; so must
  ``detect_block_size`` and the other host helpers.
* ``bdia_spmv_torch`` (K4's twin) and ``bdia_spmm_torch`` (K5's twin) must
  agree with the JAX Pallas kernels run in interpret mode in f32 within
  1e-6 of max|y| (both add the same products in (d, q) order; the margin
  covers contraction into FMAs), and with the JAX plain version
  ``_bdia_xla`` in f64 within 1e-13.  The operators are random and
  nonsymmetric, so a p/q swap fails, with offsets that reach both ends of
  a dof and nb_pad > nb, so a mask on the whole planar vector (instead of
  per dof) fails too.
* On the CPU the wrappers run the twins and launch no kernel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysolvers_tpu as pst
from pysolvers_tpu.ops import spmv as jspmv
from pysolvers_tpu.sparse.bdia import BdiaMatrix as JaxBdia
from pysolvers_tpu.sparse.bdia import detect_block_size as jax_detect
from pysolvers_tpu.sparse.host import HostCSR as JaxCSR
import pysolvers_tpu_torch as pt
from pysolvers_tpu_torch import convert
from pysolvers_tpu_torch.ops import spmv
from pysolvers_tpu_torch.sparse import bdia as tbdia
from pysolvers_tpu_torch.sparse.bdia import BdiaMatrix, detect_block_size
from pysolvers_tpu_torch.sparse.device import DiaMatrix, EllMatrix
from pysolvers_tpu_torch.sparse.host import HostCSR

torch.set_num_threads(1)

F32_TOL = 1e-6     # relative to max|y|
F64_TOL = 1e-13


def _jax_csr(H):
    return JaxCSR(H.indptr, H.indices, H.data, H.shape)


def random_block_banded(nb, b, offsets, seed, keep=0.8):
    """Node-major HostCSR with random nonsymmetric b×b blocks on the given
    block offsets; about 1 - ``keep`` of the block entries are absent."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for off in offsets:
        i = np.arange(max(0, -off), min(nb, nb - off))
        p, q = np.meshgrid(np.arange(b), np.arange(b), indexing="ij")
        r = (i[:, None] * b + p.ravel()[None, :]).ravel()
        c = ((i[:, None] + off) * b + q.ravel()[None, :]).ravel()
        mask = rng.random(len(r)) < keep
        rows.append(r[mask])
        cols.append(c[mask])
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return HostCSR.from_coo(rows, cols, rng.standard_normal(len(rows)),
                            (nb * b, nb * b))


# name -> (host matrix, b, pack keyword arguments)
PACKS = {
    "fd_b2": (pt.fd_vector_laplacian_2d(12, b=2), 2, {}),
    "fd_b3": (pt.fd_vector_laplacian_2d(12, b=3, coupling=0.2), 3, {}),
    "fd_b5": (pt.fd_vector_laplacian_2d(10, b=5, coupling=0.2), 5, {}),
    # nb = 16641 > 16384: the large row_tile regime (nb_pad = 32768)
    "fd_b2_large_tile": (pt.fd_vector_laplacian_2d(129, b=2), 2, {}),
    "fd_b3_row_tile_256": (pt.fd_vector_laplacian_2d(12, b=3), 3,
                           dict(row_tile=256)),
    "fd_b5_f32": (pt.fd_vector_laplacian_2d(10, b=5, coupling=0.2), 5,
                  dict(dtype=np.float32)),
    "random_b3": (random_block_banded(101, 3, (-37, -1, 0, 2, 37), 0), 3, {}),
    "random_b5": (random_block_banded(60, 5, (-11, 0, 4), 1), 5, {}),
}


@pytest.mark.parametrize("m,b,coupling", [(7, 2, 0.3), (12, 3, 0.2),
                                          (9, 5, 0.2)])
def test_fd_vector_laplacian_bit_equal(m, b, coupling):
    H = pt.fd_vector_laplacian_2d(m, b=b, coupling=coupling)
    J = pst.problems.fd_vector_laplacian_2d(m, b=b, coupling=coupling)
    assert H.shape == J.shape
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(H, f), getattr(J, f))
    with pytest.raises(ValueError, match="SPD"):
        pt.fd_vector_laplacian_2d(4, b=3, coupling=0.6)


@pytest.mark.parametrize("case", sorted(PACKS))
def test_pack_bit_equal(case):
    H, b, kw = PACKS[case]
    A = BdiaMatrix.from_host_csr(H, b, device="cpu", **kw)
    J = JaxBdia.from_host_csr(_jax_csr(H), b, **kw)
    np.testing.assert_array_equal(A.planes.numpy(), np.asarray(J.planes))
    assert A.planes.numpy().dtype == np.asarray(J.planes).dtype
    assert A.offsets == J.offsets and A.shape == J.shape and A.b == J.b
    assert (A.nb, A.nb_pad, A.nnz_stored) == (J.nb, J.nb_pad, J.nnz_stored)
    assert A.offsets_dev.tolist() == list(A.offsets)


def test_pack_plan_cache_is_bounded():
    for m in range(4, 24):
        BdiaMatrix.from_host_csr(pt.fd_vector_laplacian_2d(m), 2, device="cpu")
    assert len(tbdia._BDIA_PLAN_CACHE) <= 17


def test_pack_refuses_bad_shapes():
    with pytest.raises(ValueError, match="divisible"):
        BdiaMatrix.from_host_csr(pt.problems.fd_laplacian_2d(5), 2)
    with pytest.raises(ValueError, match="square"):
        BdiaMatrix.from_host_csr(HostCSR.from_dense(np.ones((4, 6))), 2)


DETECT = {
    "fd_b2": pt.fd_vector_laplacian_2d(12, b=2),
    "fd_b3": pt.fd_vector_laplacian_2d(12, b=3, coupling=0.2),
    "fd_b5": pt.fd_vector_laplacian_2d(20, b=5, coupling=0.2),
    "scalar_5pt": pt.problems.fd_laplacian_2d(40),
    "random_b3": PACKS["random_b3"][0],
    "random_b5_sparse": random_block_banded(60, 5, (-11, 0, 4), 1, keep=0.5),
}


@pytest.mark.parametrize("case", sorted(DETECT))
def test_detect_block_size_matches_jax(case):
    H = DETECT[case]
    got = detect_block_size(H)
    assert got == jax_detect(_jax_csr(H))
    if case == "scalar_5pt":
        assert got is None
    for b in (2, 3, 5):
        assert (BdiaMatrix.is_profitable(H, b)
                == JaxBdia.is_profitable(_jax_csr(H), b))


@pytest.mark.parametrize("case", ["fd_b3", "random_b5"])
def test_host_helpers_match_jax(case):
    H, b, _ = PACKS[case]
    A = BdiaMatrix.from_host_csr(H, b, device="cpu")
    J = JaxBdia.from_host_csr(_jax_csr(H), b)
    rng = np.random.default_rng(5)
    x, X = rng.random(H.shape[0]), rng.random((H.shape[0], 3))
    # planar round trips, 1-D and 2-D
    for v in (x, X):
        vp = A.to_planar(torch.from_numpy(v))
        np.testing.assert_array_equal(vp.numpy(),
                                      np.asarray(J.to_planar(jnp.asarray(v))))
        np.testing.assert_array_equal(A.from_planar(vp).numpy(), v)
    np.testing.assert_array_equal(A.diag_blocks().numpy(),
                                  np.asarray(J.diag_blocks()))
    np.testing.assert_array_equal(A.diagonal_planar().numpy(),
                                  np.asarray(J.diagonal_planar()))
    xp = A.to_planar(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(A.host_matvec_planar(xp),
                                  J.host_matvec_planar(xp))
    np.testing.assert_allclose(
        A.from_planar(torch.from_numpy(A.host_matvec_planar(xp))).numpy(),
        H.matvec(x), rtol=1e-13, atol=1e-13)
    Hc, Jc = A.to_host_csr(), J.to_host_csr()
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(Hc, f), getattr(Jc, f))
    A32 = A.astype(torch.float32)
    assert A32.dtype == torch.float32 and A32.offsets == A.offsets
    np.testing.assert_array_equal(A32.planes.numpy(),
                                  np.asarray(J.astype(jnp.float32).planes))


# twins: (nb, b, offsets, nb_pad) of random nonsymmetric planes, stored
# with nonzero values also where i + off falls outside [0, nb), so only a
# per-dof mask gives the right product
TWINS = {
    "b2_reach_both_ends": (101, 2, (-100, -3, 0, 1, 100), 128),
    "b3_odd_nb": (77, 3, (-37, -1, 0, 2, 37), 256),
    "b5_nb_pad_eq_nb": (50, 5, (-49, -7, 0, 5, 49), 50),
    "b4_positive_only": (64, 4, (0, 3, 63), 128),
}


def _twin_operator(case, dtype):
    nb, b, offsets, nb_pad = TWINS[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    planes = rng.standard_normal((len(offsets) * b, b, nb_pad)).astype(dtype)
    A = convert.bdia_from_arrays(planes, offsets, (nb * b, nb * b), b,
                                 device="cpu")
    J = JaxBdia(jnp.asarray(planes), offsets, (nb * b, nb * b), b)
    return A, J, rng


def _rel(y, y_ref):
    y_ref = np.asarray(y_ref, dtype=np.float64)
    return float(np.abs(np.asarray(y, dtype=np.float64) - y_ref).max()
                 / np.abs(y_ref).max())


@pytest.mark.parametrize("case", sorted(TWINS))
def test_k4_twin_matches_pallas_f32(case):
    A, J, rng = _twin_operator(case, np.float32)
    x = rng.standard_normal(A.n_cols).astype(np.float32)
    y = spmv.bdia_spmv_torch(A, torch.from_numpy(x))
    y_j = jspmv.bdia_spmv_pallas(J, jnp.asarray(x), interpret=True)
    assert y.dtype == torch.float32 and y.shape == (A.n_rows,)
    assert _rel(y.numpy(), y_j) <= F32_TOL


@pytest.mark.parametrize("case", sorted(TWINS))
def test_k4_twin_matches_xla_f64(case):
    A, J, rng = _twin_operator(case, np.float64)
    x = rng.standard_normal(A.n_cols)
    y = spmv.bdia_spmv_torch(A, torch.from_numpy(x))
    assert _rel(y.numpy(), jspmv.bdia_spmv(J, jnp.asarray(x))) <= F64_TOL
    # and the per-dof semantics, written out in numpy
    nb, b = A.nb, A.b
    P = A.planes.numpy()
    xb = x.reshape(b, nb)
    want = np.zeros((b, nb))
    for d, off in enumerate(A.offsets):
        for i in range(max(0, -off), min(nb, nb - off)):
            want[:, i] += P[d * b:(d + 1) * b, :, i].T @ xb[:, i + off]
    assert _rel(y.numpy(), want.reshape(-1)) <= F64_TOL


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("case", sorted(TWINS))
def test_k5_twin_matches_pallas_f32(case, k):
    A, J, rng = _twin_operator(case, np.float32)
    V = rng.standard_normal((k, A.n_cols)).astype(np.float32)
    Y = spmv.bdia_spmm_torch(A, torch.from_numpy(V))
    Y_j = jspmv.bdia_spmm_rows(J, jnp.asarray(V), interpret=True)
    assert Y.shape == (k, A.n_rows) and Y.dtype == torch.float32
    assert _rel(Y.numpy(), Y_j) <= F32_TOL


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("case", sorted(TWINS))
def test_k5_twin_matches_xla_f64(case, k):
    A, J, rng = _twin_operator(case, np.float64)
    V = rng.standard_normal((k, A.n_cols))
    Y = spmv.bdia_spmm_torch(A, torch.from_numpy(V))
    assert _rel(Y.numpy(), jspmv.bdia_spmm_rows(J, jnp.asarray(V))) \
        <= F64_TOL
    # each row is K4's twin on that row
    for r in range(k):
        np.testing.assert_array_equal(
            Y[r].numpy(), spmv.bdia_spmv_torch(A, torch.from_numpy(V[r])))


def test_column_form_and_dispatch_match_jax():
    A, J, rng = _twin_operator("b3_odd_nb", np.float64)
    X = rng.standard_normal((A.n_cols, 5))
    Y = spmv.bdia_spmm(A, torch.from_numpy(X))
    assert _rel(Y.numpy(), jspmv.bdia_spmm(J, jnp.asarray(X))) <= F64_TOL
    np.testing.assert_array_equal(pt.matmat(A, torch.from_numpy(X)).numpy(),
                                  Y.numpy())
    x = torch.from_numpy(X[:, 0].copy())
    np.testing.assert_array_equal(pt.matvec(A, x).numpy(),
                                  spmv.bdia_spmv_torch(A, x).numpy())
    dense = torch.from_numpy(rng.standard_normal((4, A.n_cols)))
    np.testing.assert_array_equal(pt.matmat(dense, torch.from_numpy(X)),
                                  dense @ torch.from_numpy(X))


def test_wrappers_on_cpu_run_the_twins(monkeypatch):
    A, _, rng = _twin_operator("b2_reach_both_ends", np.float64)
    calls = []
    real = spmv.bdia_spmm_torch
    monkeypatch.setattr(spmv, "bdia_spmm_torch",
                        lambda *a: calls.append(1) or real(*a))
    before = (spmv.bdia_spmv_launches, spmv.bdia_spmm_launches)
    x = torch.from_numpy(rng.standard_normal(A.n_cols))
    V = torch.from_numpy(rng.standard_normal((20, A.n_cols)))
    np.testing.assert_array_equal(spmv.bdia_spmv(A, x).numpy(),
                                  real(A, x[None]).numpy()[0])
    np.testing.assert_array_equal(spmv.bdia_spmm_rows(A, V).numpy(),
                                  real(A, V).numpy())
    assert len(calls) == 2
    assert (spmv.bdia_spmv_launches, spmv.bdia_spmm_launches) == before


def test_wrappers_refuse_bad_arguments():
    A, _, _ = _twin_operator("b3_odd_nb", np.float64)
    x = torch.zeros(A.n_cols)
    with pytest.raises(TypeError, match="float32"):
        spmv.bdia_spmv(A, x.float())
    with pytest.raises(ValueError, match="shape"):
        spmv.bdia_spmv(A, x[:-1])
    with pytest.raises(ValueError, match="expected"):
        spmv.bdia_spmm_rows(A, x)
    with pytest.raises(TypeError, match="float32 or float64"):
        spmv.bdia_spmv(A.astype(torch.float16), x.half())


@pytest.mark.parametrize("fmt", ["ell", "bws"])
def test_matmat_refuses_unported_formats(fmt):
    # ported since slice 10 (ell_spmm_torch; K2 per column, here its
    # twin): the product equals the column-by-column matvecs
    H = pt.problems.fd_laplacian_2d(50)
    A = {"ell": lambda: EllMatrix.from_host_csr(H, device="cpu"),
         "bws": lambda: pt.BwsMatrix.from_host_csr(H, use_rcm=False,
                                                   device="cpu")}[fmt]()
    X = torch.as_tensor(np.random.default_rng(1).random(
        (H.shape[0], 2)), dtype=A.dtype)
    Y = pt.matmat(A, X)
    for j in range(2):
        assert _rel(Y[:, j].numpy(),
                    pt.matvec(A, X[:, j].contiguous()).numpy()) <= 1e-6


def test_convert_carries_a_jax_pack_across():
    H, b, _ = PACKS["random_b3"]
    J = JaxBdia.from_host_csr(_jax_csr(H), b)
    A = convert.bdia_from_arrays(np.asarray(J.planes), J.offsets, J.shape,
                                 J.b, device="cpu")
    assert A.offsets == J.offsets and A.nb_pad == J.nb_pad
    rng = np.random.default_rng(2)
    x = rng.standard_normal(H.shape[0])
    V = rng.standard_normal((3, H.shape[0]))
    assert _rel(spmv.bdia_spmv(A, torch.from_numpy(x)).numpy(),
                jspmv.bdia_spmv(J, jnp.asarray(x))) <= F64_TOL
    assert _rel(spmv.bdia_spmm_rows(A, torch.from_numpy(V)).numpy(),
                jspmv.bdia_spmm_rows(J, jnp.asarray(V))) <= F64_TOL
