"""The card's layout of a BWS operator, built here from CPU tables
(``sparse/bws.py::bws_device_csr`` and ``row_block_table``):

* the device CSR is, bit for bit, the CSR of the permuted operator that
  the host holds (stored zeros dropped, columns ascending in each row),
  on square RCM packs, the rectangular P and R of an SA hierarchy, packs
  that spill and packs with several segment classes;
* a plain product over it agrees with the twin ``bws_spmv_torch`` and
  with the JAX ``bws_spmv`` in interpret mode within 1e-12 (f64) and 1e-5
  (f32) of max|y|: the three sum the same products in different orders;
* the row blocks cover every row once, start at every tile, and hold
  fewer than 2 · ROW_BLOCK_WINDOW nonzeros unless they are one row, the
  kernel's shared-memory stage (``kWindow`` in ``csrc/bws_spmv.cu``);
* the class block lists partition the blocks by their tiles' classes;
* a CPU matrix carries no layout, and ``bws_spmv_by_class`` runs the twin
  there.
"""
import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysolvers_tpu.ops.bws_spmv import bws_spmv as jax_bws_spmv
from pysolvers_tpu.sparse.bws import BwsMatrix as JaxBws
from pysolvers_tpu.sparse.host import HostCSR as JaxCSR
import pysolvers_tpu_torch.linear.amg as tamg
from pysolvers_tpu_torch.ops import bws_spmv as tbws
from pysolvers_tpu_torch.problems import (fem_poisson_2d_unstructured,
                                          graph_laplacian_rgg)
from pysolvers_tpu_torch.sparse.bws import (ROW_BLOCK_WINDOW, BwsMatrix,
                                            bws_device_csr, row_block_table)
from pysolvers_tpu_torch.sparse.host import HostCSR

torch.set_num_threads(1)

TOL = {np.float32: 1e-5, np.float64: 1e-12}


def _rect(n_rows, n_cols, seed, ratio, per_row=3, heavy=0.0, per_heavy=24,
          spread=300):
    """Columns near row·ratio, like aggregation-ordered AMG transfers; the
    first ``heavy`` share of the rows holds ``per_heavy`` entries within
    ``spread`` columns, so the pack spills there and has several segment
    classes (tests/test_torch_cuda.py's generator)."""
    rng = np.random.default_rng(seed)
    per = np.where(np.arange(n_rows) < heavy * n_rows, per_heavy, per_row)
    rows = np.repeat(np.arange(n_rows), per)
    centers = (np.arange(n_rows) * ratio).astype(np.int64)
    width = np.repeat(np.where(per > per_row, spread, 3), per)
    cols = np.clip(np.repeat(centers, per)
                   + rng.integers(-width, width + 1), 0, n_cols - 1)
    return HostCSR.from_coo(rows, cols, rng.standard_normal(len(rows)),
                            (n_rows, n_cols))


def _long_rows():
    """A tridiagonal matrix with one row of 1100 nonzeros (more than a
    row-block window) and one of 40 in a single column block (more than
    the slots of a row: it spills)."""
    rng = np.random.default_rng(3)
    n = 1200
    D = np.diag(rng.standard_normal(n) + 4.0)
    D += np.diag(rng.standard_normal(n - 1), 1)
    D += np.diag(rng.standard_normal(n - 1), -1)
    D[700, :1100] = rng.standard_normal(1100)
    D[5, 256:296] = rng.standard_normal(40)
    return HostCSR.from_dense(D)


def _sa_transfers():
    A = fem_poisson_2d_unstructured(40, seed=3)
    Ap = A.permute_symmetric(BwsMatrix._rcm_perm(A))
    mlh = tamg.build_sa_hierarchy(Ap, 3)
    return mlh.prolongators[-1], mlh.restrictions[-1]


_P, _R = _sa_transfers()
# name -> (host matrix, pack keyword arguments); the transfers as
# amg.build_device_hierarchy packs them
CASES = {
    "fem_rcm": (fem_poisson_2d_unstructured(40, seed=3), dict(use_rcm=True)),
    "rgg_rcm": (graph_laplacian_rgg(1500, seed=1), dict(use_rcm=True)),
    "sa_P": (_P, dict(use_rcm=False, gt="auto")),
    "sa_R": (_R, dict(use_rcm=False, gt="auto")),
    "long_rows": (_long_rows(), dict(use_rcm=False, group_rows=8)),
    "multi_class": (fem_poisson_2d_unstructured(60, seed=3),
                    dict(use_rcm=False)),
    "classes_tall": (_rect(6000, 1500, 0, 0.25, heavy=0.25),
                     dict(use_rcm=False)),
    "classes_wide": (_rect(1500, 6000, 1, 4.0, heavy=0.25),
                     dict(use_rcm=False)),
}
CLASS_CASES = ["multi_class", "classes_tall", "classes_wide"]


def _pack(name, dtype):
    H, kw = CASES[name]
    return H, BwsMatrix.from_host_csr(H, dtype=dtype, device="cpu", **kw)


def _host_csr_in_pack_order(H, T, dtype):
    """(indptr, indices, values) of the host operator in the pack's
    ordering, values cast to the pack's type, zeros dropped, columns
    ascending in each row."""
    perm = T.perm.numpy().astype(np.int64)
    if H.shape[0] == H.shape[1]:
        H = H.permute_symmetric(perm)
    else:
        assert np.array_equal(perm, np.arange(H.shape[0]))
    rows, cols, vals = H.to_coo()
    vals = vals.astype(dtype)
    keep = vals != 0
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    order = np.lexsort((cols, rows))
    indptr = np.zeros(H.shape[0] + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=H.shape[0]), out=indptr[1:])
    return indptr, cols[order], vals[order]


def _csr_product(L, x, n_rows):
    """The plain product over the layout."""
    rows = torch.repeat_interleave(torch.arange(n_rows),
                                   (L.indptr[1:] - L.indptr[:-1]).long())
    y = torch.zeros(n_rows, dtype=x.dtype)
    return y.index_add_(0, rows, L.values * x[L.indices.long()])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", sorted(CASES))
def test_layout_is_the_host_csr_in_pack_order(name, dtype):
    H, T = _pack(name, dtype)
    L = bws_device_csr(T)
    indptr, indices, values = _host_csr_in_pack_order(H, T, dtype)
    assert L.indptr.dtype == torch.int32 and L.indices.dtype == torch.int32
    assert L.values.dtype == T.dtype
    assert np.array_equal(L.indptr.numpy(), indptr)
    assert np.array_equal(L.indices.numpy(), indices)
    assert np.array_equal(L.values.numpy(), values)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", sorted(CASES))
def test_layout_product_matches_the_twin(name, dtype):
    H, T = _pack(name, dtype)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        H.shape[1]).astype(dtype))
    y = _csr_product(bws_device_csr(T), x, T.n_rows)
    y_ref = tbws.bws_spmv_torch(T, x)
    assert y.shape == (H.shape[0],)
    assert float((y - y_ref).abs().max()) <= TOL[dtype] * float(
        y_ref.abs().max())


@pytest.mark.parametrize("name", ["fem_rcm", "sa_R", "multi_class",
                                  "classes_tall"])
def test_layout_product_matches_jax_kernel(name):
    H, kw = CASES[name]
    T = BwsMatrix.from_host_csr(H, dtype=np.float32, device="cpu", **kw)
    J = JaxBws.from_host_csr(JaxCSR(H.indptr, H.indices, H.data, H.shape),
                             dtype=np.float32, _device=False, **kw)
    x = np.random.default_rng(5).standard_normal(H.shape[1]).astype(
        np.float32)
    Jd = jax.tree_util.tree_map(jnp.asarray, J)
    y_ref = np.asarray(jax_bws_spmv(Jd, jnp.asarray(x), interpret=True))
    y = _csr_product(bws_device_csr(T), torch.from_numpy(x), T.n_rows)
    assert np.abs(y.numpy() - y_ref).max() <= 1e-5 * np.abs(y_ref).max()


def _check_blocks(indptr, blocks, rows_per_tile):
    """Every row in exactly one block, every tile start a block start,
    and a block of several rows below twice the window."""
    n_rows = indptr.numel() - 1
    b = blocks.numpy().astype(np.int64)
    assert blocks.dtype == torch.int32
    assert b[0] == 0 and b[-1] == n_rows and np.all(np.diff(b) > 0)
    assert set(range(0, n_rows, rows_per_tile)) <= set(b[:-1].tolist())
    ptr = indptr.numpy().astype(np.int64)
    nnz = ptr[b[1:]] - ptr[b[:-1]]
    several = np.diff(b) > 1
    assert np.all(nnz[several] < 2 * ROW_BLOCK_WINDOW)
    return b, nnz


@pytest.mark.parametrize("name", sorted(CASES))
def test_row_blocks_of_each_pack(name):
    _, T = _pack(name, np.float64)
    L = bws_device_csr(T)
    b, nnz = _check_blocks(L.indptr, L.row_blocks, T.gt * T.group_rows)
    if name == "long_rows":       # the 1100-nonzero row is a block alone
        assert np.array_equal(b[np.flatnonzero(b == 700)[0]:][:2],
                              [700, 701])
        assert nnz.max() > ROW_BLOCK_WINDOW


@pytest.mark.parametrize("lengths", [
    [7] * 5000,                                   # FEM-like rows
    [0] * 3000 + [3] * 10 + [0] * 3000,           # mostly empty rows
    [2] * 100 + [5000] + [2] * 100 + [1500, 1025, 1024, 1] * 3 + [0],
    [2048] * 4,                                   # long rows only
    [0] * 10,                                     # no nonzeros at all
])
@pytest.mark.parametrize("rows_per_tile", [256, 8192])
@pytest.mark.parametrize("ptr_dtype", [torch.int32, torch.int64])
def test_row_block_table_budget(lengths, rows_per_tile, ptr_dtype):
    """int64 row pointers are what a layout of 2**31 nonzeros or more
    carries; the table is the same int32 one."""
    indptr = torch.from_numpy(np.concatenate([[0], np.cumsum(lengths)])).to(
        ptr_dtype)
    b, nnz = _check_blocks(indptr, row_block_table(indptr, rows_per_tile),
                           rows_per_tile)
    long_rows = np.flatnonzero(np.asarray(lengths) > ROW_BLOCK_WINDOW)
    for r in long_rows:                           # each a block of its own
        i = np.flatnonzero(b == r)
        assert len(i) == 1 and b[i[0] + 1] == r + 1


def test_kernel_window_is_the_partition_window():
    """K2/K3 stage a block of several rows in 2 · kWindow slots of shared
    memory; the partition's window must be the kernel's."""
    src = (pathlib.Path(tbws.__file__).resolve().parent.parent / "csrc"
           / "bws_spmv.cu").read_text()
    found = re.findall(r"constexpr int kWindow = (\d+);", src)
    assert found == [str(ROW_BLOCK_WINDOW)]


@pytest.mark.parametrize("name", CLASS_CASES)
def test_class_blocks_partition_the_blocks(name):
    _, T = _pack(name, np.float64)
    assert len(T.s_classes) >= 2
    L = bws_device_csr(T)
    starts = L.class_starts
    assert len(starts) == len(T.s_classes) + 1 and starts[-1] == L.n_blocks
    ids = L.class_blocks.numpy()
    assert sorted(ids.tolist()) == list(range(L.n_blocks))
    tile_of_block = L.row_blocks.numpy()[:-1] // (T.gt * T.group_rows)
    for c, (_, tiles) in enumerate(T.s_classes):
        mine = ids[starts[c]:starts[c + 1]]
        assert np.all(np.diff(mine) > 0)          # block order kept
        assert set(tile_of_block[mine].tolist()) <= set(tiles)


def test_class_product_rows_come_from_their_class():
    """Summing each class's block rows alone rebuilds the whole product:
    the class lists are what K3 walks."""
    H, T = _pack("classes_tall", np.float64)
    L = bws_device_csr(T)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(H.shape[1]))
    y_all = _csr_product(L, x, T.n_rows)
    y = torch.full((T.n_rows,), float("nan"), dtype=torch.float64)
    b = L.row_blocks.long()
    for c in range(len(T.s_classes)):
        for blk in L.class_blocks[L.class_starts[c]:L.class_starts[c + 1]]:
            r0, r1 = int(b[blk]), int(b[blk + 1])
            assert torch.isnan(y[r0:r1]).all()    # written once
            y[r0:r1] = y_all[r0:r1]
    assert torch.equal(y, y_all)


def test_cpu_matrix_carries_no_layout():
    _, T = _pack("multi_class", np.float32)
    assert T.csr is None
    assert dataclasses.replace(T, s_classes=()).csr is None


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_by_class_on_the_cpu_is_the_twin(dtype):
    H, T = _pack("multi_class", dtype)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        H.shape[1]).astype(dtype))
    before = (tbws.bws_spmv_launches, tbws.bws_spmv_classes_launches)
    y = tbws.bws_spmv_by_class(T, x)
    assert (tbws.bws_spmv_launches, tbws.bws_spmv_classes_launches) == before
    assert torch.equal(y, tbws.bws_spmv_torch(T, x))
    assert torch.equal(y, tbws.bws_spmv(T, x))
    with pytest.raises(ValueError, match="no segment classes"):
        tbws.bws_spmv_by_class(dataclasses.replace(T, s_classes=()), x)


def test_layout_of_an_all_zero_pack():
    """Every stored value 0: no nonzeros, one row block per tile."""
    _, T = _pack("fem_rcm", np.float64)
    Z = dataclasses.replace(T, data=torch.zeros_like(T.data))
    L = bws_device_csr(Z)
    assert L.nnz == 0 and int(L.indptr[-1]) == 0
    _check_blocks(L.indptr, L.row_blocks, T.gt * T.group_rows)
    assert torch.equal(_csr_product(L, torch.ones(T.n_cols,
                                                  dtype=torch.float64),
                                    T.n_rows), torch.zeros(T.n_rows,
                                                           dtype=torch.float64))
