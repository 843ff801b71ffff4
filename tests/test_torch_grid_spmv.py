"""The port's grid-DIA operator (``ops/grid_spmv.py``, K6's twin) and DIA
SpMM against the JAX package.

f32: the twin against the JAX Pallas kernel in interpret mode, within 1e-6
of max|y| (both add the D terms in pair order in f32; XLA and torch may
round the products differently).  f64: the twin against a numpy oracle,
within 1e-13 of max|y| (the same terms, summed in another order).  Tables
built directly are random and nonzero at every position, column and row
edges included, on non-square grids, so a twin that indexes x flat
(wrapping grid rows) or swaps the dimensions fails."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysolvers_tpu as pst
import pysolvers_tpu.ops.spmv as jspmv
from pysolvers_tpu.ops.grid_spmv import GridDiaMatrix as JaxGrid
from pysolvers_tpu.ops.grid_spmv import grid_dia_spmv as jax_grid_spmv
from pysolvers_tpu.sparse.device import DiaMatrix as JaxDia
import pysolvers_tpu_torch as pt
from pysolvers_tpu_torch import convert
from pysolvers_tpu_torch.ops import grid_spmv, spmv
from pysolvers_tpu_torch.ops.grid_spmv import GridDiaMatrix
from pysolvers_tpu_torch.sparse.device import DiaMatrix
from pysolvers_tpu_torch.sparse.host import HostCSR

torch.set_num_threads(1)

ALL_PAIRS = tuple((dr, dc) for dr in range(-2, 3) for dc in range(-8, 9))


def _nine_point(m, seed=1, dtype=np.float32):
    """Random-valued 9-point stencil (the Galerkin-coarse shape), as
    tests/test_grid_spmv.py builds it."""
    ii, jj = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
    g = ii * m + jj
    rows, cols, vals = [], [], []
    rng = np.random.default_rng(seed)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            ni, nj = ii + di, jj + dj
            ok = (ni >= 0) & (ni < m) & (nj >= 0) & (nj < m)
            rows.append(g[ok])
            cols.append((ni * m + nj)[ok])
            vals.append(rng.normal(size=int(ok.sum())))
    return (np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals).astype(dtype), (m * m, m * m))


def _stencil(case, dtype):
    """(JAX HostCSR, port HostCSR, dims) of a stencil case."""
    if case.startswith("5pt"):
        m = int(case[4:])
        return (pst.problems.fd_laplacian_2d(m, dtype=dtype),
                pt.problems.fd_laplacian_2d(m, dtype=dtype), (m, m))
    coo = _nine_point(24, dtype=dtype)
    return (pst.HostCSR.from_coo(*coo), HostCSR.from_coo(*coo), (24, 24))


def _random_table(dims, dtype, seed=3):
    """A JAX-layout (85, mr_pad, mc_o) table, random everywhere."""
    mr, mc = dims
    rng = np.random.default_rng(seed)
    return rng.standard_normal((len(ALL_PAIRS), -(-mr // 64) * 64,
                                -(-mc // 128) * 128)).astype(dtype)


def _oracle(G, pairs, dims, x):
    """y[r, c] = sum_d G[d, r, c] x[r + dr, c + dc] over on-grid
    neighbours, by explicit index masks (f64 numpy)."""
    mr, mc = dims
    X = x.reshape(mr, mc).astype(np.float64)
    y = np.zeros((mr, mc))
    r = np.arange(mr)[:, None]
    c = np.arange(mc)[None, :]
    for d, (dr, dc) in enumerate(pairs):
        rr, cc = r + dr, c + dc
        ok = (rr >= 0) & (rr < mr) & (cc >= 0) & (cc < mc)
        y += np.where(ok, G[d, :mr, :mc].astype(np.float64)
                      * X[np.clip(rr, 0, mr - 1), np.clip(cc, 0, mc - 1)], 0)
    return y.reshape(-1)


def _rel(y, y_ref):
    return np.abs(y - y_ref).max() / np.abs(y_ref).max()


STENCILS = ["5pt_17", "5pt_40", "9pt_24"]
RANDOM_DIMS = [(13, 37), (37, 13)]


@pytest.mark.parametrize("case", STENCILS)
def test_stencil_twin_f32_matches_jax_kernel(case):
    Hj, Ht, dims = _stencil(case, np.float32)
    Gj = JaxGrid.from_dia(JaxDia.from_host_csr(Hj), dims)
    Gt = GridDiaMatrix.from_dia(DiaMatrix.from_host_csr(Ht, device="cpu"),
                                dims)
    x = np.random.default_rng(0).random(Ht.shape[0]).astype(np.float32)
    y_ref = np.asarray(jax_grid_spmv(Gj, jnp.asarray(x)))
    y = grid_spmv.grid_dia_spmv(Gt, torch.from_numpy(x)).numpy()
    assert y.dtype == np.float32
    assert _rel(y, y_ref) <= 1e-6


@pytest.mark.parametrize("dims", RANDOM_DIMS)
def test_random_table_twin_f32_matches_jax_kernel(dims):
    mr, mc = dims
    G = _random_table(dims, np.float32)
    Gj = JaxGrid(jnp.asarray(G), ALL_PAIRS, dims, (mr * mc, mr * mc))
    Gt = convert.grid_dia_from_arrays(G, ALL_PAIRS, dims, device="cpu")
    x = np.random.default_rng(1).standard_normal(mr * mc).astype(np.float32)
    y_ref = np.asarray(jax_grid_spmv(Gj, jnp.asarray(x)))
    y = grid_spmv.grid_dia_spmv(Gt, torch.from_numpy(x)).numpy()
    assert _rel(y, y_ref) <= 1e-6
    # the edges matter: a flat-indexing product differs there
    flat = np.zeros(mr * mc)
    for d, (dr, dc) in enumerate(ALL_PAIRS):
        idx = np.arange(mr * mc) + dr * mc + dc
        ok = (idx >= 0) & (idx < mr * mc)
        flat[ok] += G[d, :mr, :mc].reshape(-1)[ok] * x[idx[ok]]
    assert _rel(flat, y_ref) > 1e-2


@pytest.mark.parametrize("case", STENCILS + [f"random_{mr}x{mc}"
                                             for mr, mc in RANDOM_DIMS])
def test_twin_f64_matches_numpy_oracle(case):
    if case.startswith("random"):
        dims = tuple(int(v) for v in case[7:].split("x"))
        G, pairs = _random_table(dims, np.float64), ALL_PAIRS
        Gt = convert.grid_dia_from_arrays(G, pairs, dims, device="cpu")
    else:
        _, Ht, dims = _stencil(case, np.float64)
        Gt = GridDiaMatrix.from_dia(DiaMatrix.from_host_csr(Ht, device="cpu"),
                                    dims)
        G, pairs = Gt.diags.numpy(), Gt.pairs
    x = np.random.default_rng(2).standard_normal(dims[0] * dims[1])
    y = grid_spmv.grid_dia_spmv(Gt, torch.from_numpy(x)).numpy()
    assert _rel(y, _oracle(G, pairs, dims, x)) <= 1e-13
    if not case.startswith("random"):
        assert _rel(y, Ht.matvec(x)) <= 1e-13


@pytest.mark.parametrize("case", ["5pt_17", "9pt_24"])
def test_conversions_match_jax(case):
    """from_dia and from_dia_device give the JAX pairs and tables."""
    Hj, Ht, dims = _stencil(case, np.float64)
    mr, mc = dims
    Aj = JaxDia.from_host_csr(Hj)
    At = DiaMatrix.from_host_csr(Ht, device="cpu")
    for conv in ("from_dia", "from_dia_device"):
        Gj = getattr(JaxGrid, conv)(Aj, dims)
        Gt = getattr(GridDiaMatrix, conv)(At, dims)
        assert Gt.pairs == Gj.pairs
        assert Gt.dims == Gj.dims and Gt.shape == Gj.shape
        assert Gt.pairs_dev.tolist() == [list(p) for p in Gj.pairs]
        assert Gt.ldc % grid_spmv.ROW_ALIGN == 0 and Gt.ldc >= mc
        np.testing.assert_array_equal(Gt.diags[:, :, :mc].numpy(),
                                      np.asarray(Gj.diags)[:, :mr, :mc])
        assert not Gt.diags[:, :, mc:].any()


def test_row_wrap_refused():
    # a flat +1 entry at the end of a grid row wraps to the next row —
    # grid semantics would drop it; from_dia must refuse
    m = 8
    n = m * m
    rows = np.arange(n - 1)
    d = np.arange(n)
    H = HostCSR.from_coo(np.concatenate([rows, d]),
                         np.concatenate([rows + 1, d]),
                         np.concatenate([np.ones(n - 1), 4.0 * np.ones(n)]),
                         (n, n))
    with pytest.raises(ValueError, match="wrap"):
        GridDiaMatrix.from_dia(DiaMatrix.from_host_csr(H, device="cpu"),
                               (m, m))


def test_undecomposable_offset_refused():
    m = 10
    n = m * m
    d = np.arange(n)
    far = np.arange(n - 37)
    H = HostCSR.from_coo(
        np.concatenate([d, far]), np.concatenate([d, far + 37]),
        np.concatenate([4.0 * np.ones(n), np.ones(n - 37)]), (n, n))
    A = DiaMatrix.from_host_csr(H, device="cpu")
    for conv in (GridDiaMatrix.from_dia, GridDiaMatrix.from_dia_device):
        with pytest.raises(ValueError, match="decomposition"):
            conv(A, (m, m))
    with pytest.raises(ValueError, match="dims"):
        GridDiaMatrix.from_dia(A, (m, m + 1))


def test_matvec_dispatch_and_cpu_wrapper_runs_the_twin(monkeypatch):
    m = 20
    Ht = pt.problems.fd_laplacian_2d(m)
    G = GridDiaMatrix.from_dia(DiaMatrix.from_host_csr(Ht, device="cpu"),
                               (m, m))
    x = torch.from_numpy(np.random.default_rng(1).random(m * m))
    calls = []
    real = grid_spmv.grid_dia_spmv_torch
    monkeypatch.setattr(grid_spmv, "grid_dia_spmv_torch",
                        lambda *a: calls.append(1) or real(*a))
    before = grid_spmv.grid_dia_spmv_launches
    np.testing.assert_array_equal(pt.matvec(G, x).numpy(),
                                  real(G, x).numpy())
    assert calls == [1]
    assert grid_spmv.grid_dia_spmv_launches == before


def test_wrapper_refuses_bad_arguments():
    G = convert.grid_dia_from_arrays(_random_table((13, 37), np.float64),
                                     ALL_PAIRS, (13, 37), device="cpu")
    x = torch.zeros(13 * 37, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        grid_spmv.grid_dia_spmv(G, x.float())
    with pytest.raises(ValueError, match="shape"):
        grid_spmv.grid_dia_spmv(G, x[:-1])
    with pytest.raises(ValueError, match="pairs_dev"):
        GridDiaMatrix(G.diags, G.pairs, G.pairs_dev[:-1], G.dims, G.shape)
    with pytest.raises(ValueError, match="grid table"):
        GridDiaMatrix(G.diags[:, :, :30], G.pairs, G.pairs_dev, G.dims,
                      G.shape)


def test_convert_round_trips_a_jax_table():
    dims = (37, 13)
    G = _random_table(dims, np.float64, seed=9)
    Gt = convert.grid_dia_from_arrays(G, ALL_PAIRS, dims, device="cpu")
    assert Gt.pairs == ALL_PAIRS and Gt.dims == dims
    np.testing.assert_array_equal(Gt.diags[:, :, :13].numpy(),
                                  G[:, :37, :13])
    back = convert.grid_dia_from_arrays(Gt.diags.numpy(), Gt.pairs, dims,
                                        device="cpu")
    np.testing.assert_array_equal(back.diags.numpy(), Gt.diags.numpy())


def _banded(shape, offsets, seed):
    rng = np.random.default_rng(seed)
    n, nc = shape
    rows, cols = [], []
    for off in offsets:
        i = np.arange(max(0, -off), min(n, nc - off))
        rows.append(i)
        cols.append(i + off)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return rows, cols, rng.standard_normal(len(rows)), shape


SPMM_CASES = {
    "square": ((400, 400), (-20, -1, 0, 1, 20)),
    "wide": ((300, 377), (-3, 0, 5, 80)),
    "tall": ((377, 300), (-80, -1, 0, 2)),
    "nine_offsets": ((625, 625), (-26, -25, -24, -1, 0, 1, 24, 25, 26)),
}


@pytest.mark.parametrize("case", sorted(SPMM_CASES))
def test_dia_spmm_matches_jax(case):
    coo = _banded(*SPMM_CASES[case], seed=len(case))
    Aj = JaxDia.from_host_csr(pst.HostCSR.from_coo(*coo))
    At = DiaMatrix.from_host_csr(HostCSR.from_coo(*coo), device="cpu")
    X = np.random.default_rng(4).standard_normal((At.n_cols, 5))
    Y_ref = np.asarray(jspmv.dia_spmm(Aj, jnp.asarray(X)))
    Y = spmv.dia_spmm(At, torch.from_numpy(X)).numpy()
    assert Y.shape == (At.n_rows, 5)
    assert np.linalg.norm(Y - Y_ref) / np.linalg.norm(Y_ref) <= 1e-14
    np.testing.assert_array_equal(pt.matmat(At, torch.from_numpy(X)).numpy(),
                                  Y)
    # each column is the SpMV of that column
    for j in range(5):
        y = spmv.dia_spmv_torch(At, torch.from_numpy(X[:, j].copy()))
        assert _rel(Y[:, j], y.numpy()) <= 1e-14
