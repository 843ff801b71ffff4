"""The port's BWS pack and SpMV twin against the JAX package's.

* The pack (``sparse/bws.py``) must give the JAX package's arrays bit for
  bit: delta, data, lidx, base, perm, iperm and the static fields.
* ``bws_spmv_torch`` (the twin of kernels K2/K3) must agree with the JAX
  ``bws_spmv`` run in interpret mode on the same pack: within 1e-6 of
  max|y| in f32, since both sum the same products in different orders
  (the JAX kernel selects x exactly, with HIGHEST-precision one-hot
  matmuls); and with the host CSR product in f64 within 1e-13.
* On the CPU the wrapper runs the twin and launches no kernel.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysolvers_tpu.ops.bws_spmv import bws_spmv as jax_bws_spmv
from pysolvers_tpu.sparse.bws import BwsMatrix as JaxBws
from pysolvers_tpu.sparse.host import HostCSR as JaxCSR
from pysolvers_tpu_torch import convert
from pysolvers_tpu_torch.ops import bws_spmv as tbws
from pysolvers_tpu_torch.problems import (fem_poisson_2d_unstructured,
                                          graph_laplacian_rgg)
from pysolvers_tpu_torch.sparse.bws import BwsMatrix
from pysolvers_tpu_torch.sparse.host import HostCSR

torch.set_num_threads(1)

F32_TOL = 1e-6     # relative to max|y|: summation order only
F64_TOL = 1e-13


def _rand_rect(n_rows, n_cols, per_row, seed, ratio):
    """Banded-ish rectangular matrix: columns near row·ratio, like the
    aggregation-ordered AMG transfers (tests/test_bws.py's generator)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n_rows), per_row)
    centers = (np.arange(n_rows) * ratio).astype(np.int64)
    cols = np.clip(np.repeat(centers, per_row)
                   + rng.integers(-3, 4, size=len(rows)), 0, n_cols - 1)
    return HostCSR.from_coo(rows, cols, rng.standard_normal(len(rows)),
                            (n_rows, n_cols))


def _spill():
    """One row with 40 nonzeros in one 128-column block: more than any
    geometry's slots, so it spills into extra segment instances."""
    rng = np.random.default_rng(2)
    D = np.eye(200)
    D[5, :40] = rng.standard_normal(40) + 2.0
    return HostCSR.from_dense(D)


FEM = fem_poisson_2d_unstructured(40, seed=3)

# name -> (host matrix, pack keyword arguments)
PACKS = {
    "fem_rcm": (FEM, dict(use_rcm=True)),
    "fem_no_rcm": (FEM, dict(use_rcm=False)),
    "fem_f64": (FEM, dict(use_rcm=True, dtype=np.float64)),
    "rgg": (graph_laplacian_rgg(1500, seed=1), dict(use_rcm=True)),
    "spill": (_spill(), dict(use_rcm=False)),
    "tall": (_rand_rect(2000, 500, 3, 0, 0.25), dict(use_rcm=False)),
    "wide": (_rand_rect(500, 2000, 6, 1, 4.0), dict(use_rcm=False)),
    "multi_class": (fem_poisson_2d_unstructured(60, seed=3),
                    dict(use_rcm=False)),
}
# the legal (group_rows, gt) grid of tests/test_bws.py, on the FEM matrix
for _gr, _gts in ((32, (128, 64, 32, 16, 8)), (16, (32, 8)), (8, (64, 16))):
    for _gt in _gts:
        PACKS[f"fem_gr{_gr}_gt{_gt}"] = (FEM, dict(use_rcm=True,
                                                   group_rows=_gr, gt=_gt))
PACKS["fem_gr32_gt_auto"] = (FEM, dict(use_rcm=True, group_rows=32,
                                       gt="auto"))


def _jax_csr(H):
    return JaxCSR(H.indptr, H.indices, H.data, H.shape)


def _packs(name):
    H, kw = PACKS[name]
    kw = {"dtype": np.float32, **kw}
    J = JaxBws.from_host_csr(_jax_csr(H), _device=False, **kw)
    return H, J, BwsMatrix.from_host_csr(H, device="cpu", **kw)


@pytest.mark.parametrize("name", sorted(PACKS))
def test_pack_bit_equal_to_jax(name):
    _, J, T = _packs(name)
    for f in ("delta", "data", "lidx", "base", "perm", "iperm"):
        a, b = np.asarray(getattr(J, f)), getattr(T, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a, b), f
    for f in ("shape", "win_blocks", "group_rows", "gt", "s_classes",
              "fast_select"):
        assert getattr(T, f) == getattr(J, f), f
    assert T.slots == J.slots and T.n_segments == J.n_segments
    assert T.classed_slots == J.classed_slots
    assert T.kernel_cost == J.kernel_cost


def test_spill_makes_extra_segments():
    _, _, T = _packs("spill")
    assert T.n_segments >= 3


def test_multi_class_pack_takes_the_class_path():
    _, _, T = _packs("multi_class")
    assert len(T.s_classes) >= 2 and tbws.use_classes(T)
    ids = T.tile_ids.tolist()
    assert sorted(ids) == list(range(T.n_groups // T.gt))


def test_rcm_on_rectangular_raises():
    with pytest.raises(ValueError, match="use_rcm"):
        BwsMatrix.from_host_csr(_rand_rect(400, 100, 3, 2, 0.25),
                                use_rcm=True, device="cpu")


def test_invalid_gt_raises():
    with pytest.raises(ValueError, match="gt"):
        BwsMatrix.from_host_csr(FEM, group_rows=8, gt=8, device="cpu")


def test_classes_must_partition_tiles():
    _, _, T = _packs("multi_class")
    S_c, ids = T.s_classes[0]
    with pytest.raises(ValueError, match="partition"):
        dataclasses.replace(T, s_classes=T.s_classes[1:])
    with pytest.raises(ValueError, match="partition"):
        dataclasses.replace(T, s_classes=T.s_classes + ((S_c, ids),))


SPMV_CASES = ["fem_rcm", "spill", "tall", "wide", "multi_class",
              "fem_gr8_gt16"]


@pytest.mark.parametrize("name", SPMV_CASES)
def test_twin_matches_jax_kernel(name):
    H, J, T = _packs(name)
    x = np.random.default_rng(5).standard_normal(H.shape[1]).astype(
        np.float32)
    Jd = jax.tree_util.tree_map(jnp.asarray, J)
    y_ref = np.asarray(jax_bws_spmv(Jd, jnp.asarray(x), interpret=True))
    y = tbws.bws_spmv(T, torch.from_numpy(x)).numpy()
    assert y.shape == (H.shape[0],) and y.dtype == np.float32
    assert np.abs(y - y_ref).max() <= F32_TOL * np.abs(y_ref).max()


@pytest.mark.parametrize("name", ["fem_f64", "tall", "wide", "spill",
                                  "multi_class"])
def test_twin_matches_host_product_f64(name):
    H, kw = PACKS[name]
    T = BwsMatrix.from_host_csr(H, device="cpu",
                                **{**kw, "dtype": np.float64})
    x = np.random.default_rng(6).standard_normal(H.shape[1])
    perm = T.perm.numpy()
    if H.shape[0] == H.shape[1]:
        y = tbws.bws_matvec(T, torch.from_numpy(x)).numpy()
    else:
        y = tbws.bws_spmv(T, torch.from_numpy(x)).numpy()
        assert np.array_equal(perm, np.arange(H.shape[0]))
    y_ref = H.matvec(x)
    assert np.abs(y - y_ref).max() <= F64_TOL * np.abs(y_ref).max()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_class_path_matches_plain_path(dtype):
    H, kw = PACKS["multi_class"]
    T = BwsMatrix.from_host_csr(H, device="cpu", **{**kw, "dtype": dtype})
    assert tbws.use_classes(T)
    plain = dataclasses.replace(T, s_classes=())
    assert not tbws.use_classes(plain) and plain.tile_ids.numel() == 0
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        H.shape[1]).astype(dtype))
    y_cls = tbws.bws_spmv(T, x).numpy()
    y_one = tbws.bws_spmv(plain, x).numpy()
    tol = F32_TOL if dtype == np.float32 else F64_TOL
    assert np.abs(y_cls - y_one).max() <= tol * np.abs(y_one).max()


def test_carried_across_pack_matches():
    """A JAX pack rebuilt by convert.bws_from_arrays equals the port's."""
    _, J, T = _packs("multi_class")
    C = convert.bws_from_arrays(
        np.asarray(J.delta), np.asarray(J.data), np.asarray(J.lidx),
        np.asarray(J.perm), np.asarray(J.iperm), np.asarray(J.base),
        J.shape, J.win_blocks, J.group_rows, J.s_classes, J.gt,
        J.fast_select, device="cpu")
    for f in ("delta", "data", "lidx", "base", "perm", "iperm", "tile_ids"):
        assert torch.equal(getattr(C, f), getattr(T, f)), f
    assert C.s_classes == T.s_classes and C.shape == T.shape


def test_wrapper_checks_its_input():
    _, _, T = _packs("fem_rcm")
    with pytest.raises(TypeError, match="float64"):
        tbws.bws_spmv(T, torch.zeros(T.n_cols, dtype=torch.float64))
    with pytest.raises(ValueError, match="shape"):
        tbws.bws_spmv(T, torch.zeros(T.n_cols + 1, dtype=torch.float32))


def test_cpu_wrapper_launches_no_kernel():
    H, _, T = _packs("multi_class")
    before = (tbws.bws_spmv_launches, tbws.bws_spmv_classes_launches)
    x = torch.ones(H.shape[1], dtype=torch.float32)
    tbws.bws_spmv(T, x)
    tbws.bws_spmv(dataclasses.replace(T, s_classes=()), x)
    assert (tbws.bws_spmv_launches, tbws.bws_spmv_classes_launches) == before
