"""The port's SpMV against the JAX package on the same seeded inputs.

f32: the port's DIA SpMV (the plain twin ``dia_spmv_torch``, which the
wrapper runs for CPU tensors) against the TPU kernel ``dia_spmv_pallas`` in
interpret mode; f64: against ``dia_spmv_xla``.  Tolerance, relative to
max|y|: 1e-6 in f32 and 1e-13 in f64 — both sides add the same products in
the same offset order, but XLA may fuse or reorder the elementwise chain,
which moves each partial sum by a few ulps.

Kernel K1 itself is checked against its twin on the card in
``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysolvers_tpu.ops.spmv as jspmv
import pysolvers_tpu.sparse.device as jdev
import pysolvers_tpu.sparse.host as jhost
import pysolvers_tpu_torch.ops.spmv as tspmv
from pysolvers_tpu_torch import convert
from pysolvers_tpu_torch.sparse.device import DiaMatrix, EllMatrix
from pysolvers_tpu_torch.sparse.host import HostCSR

torch.set_num_threads(1)

RTOL = {np.float32: 1e-6, np.float64: 1e-13}


def _banded(shape, offsets, seed=0):
    """Random banded (n_rows, n_cols) matrix with the given offsets, as
    COO triplets (both packages build their own HostCSR from them)."""
    rng = np.random.default_rng(seed)
    n, nc = shape
    rows, cols = [], []
    for off in offsets:
        i = np.arange(max(0, -off), min(n, nc - off))
        rows.append(i)
        cols.append(i + off)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return rows, cols, rng.standard_normal(len(rows)), shape


DIA_CASES = {
    "square_5pt": ((400, 400), (-20, -1, 0, 1, 20)),
    "wide": ((300, 377), (-3, 0, 5, 80)),
    "tall": ((377, 300), (-80, -1, 0, 2)),
    "negative_only": ((257, 257), (-200, -7, -1)),
    "wide_offsets": ((500, 500), (-450, -99, -1, 0, 1, 99, 250, 300, 450)),
    "D1_diagonal": ((123, 123), (0,)),
    "D1_shifted": ((123, 140), (9,)),
}


def _pair(case, dtype):
    rows, cols, vals, shape = _banded(*DIA_CASES[case])
    Hj = jhost.HostCSR.from_coo(rows, cols, vals.astype(dtype), shape)
    Ht = HostCSR.from_coo(rows, cols, vals.astype(dtype), shape)
    x = np.random.default_rng(1).random(shape[1]).astype(dtype)
    return Hj, Ht, x


def _jax_dia(Hj, x, dtype):
    Aj = jdev.DiaMatrix.from_host_csr(Hj)
    if dtype == np.float32:
        return np.asarray(jspmv.dia_spmv_pallas(Aj, jnp.asarray(x),
                                                interpret=True)), Aj
    return np.asarray(jspmv.dia_spmv_xla(Aj, jnp.asarray(x))), Aj


def _close(y, y_ref, rtol):
    assert y.shape == y_ref.shape
    scale = max(np.abs(y_ref).max(), 1e-300)
    err = np.abs(y - y_ref).max() / scale
    assert err <= rtol, f"rel err {err:.3e} > {rtol:g}"


@pytest.mark.parametrize("case", sorted(DIA_CASES))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("source", ["host_csr", "jax_arrays"])
def test_dia_matches_jax(case, dtype, source):
    """``source``: the port packs the HostCSR itself, or takes the JAX
    package's padded diagonal table through convert.py."""
    Hj, Ht, x = _pair(case, dtype)
    y_ref, Aj = _jax_dia(Hj, x, dtype)
    if source == "host_csr":
        At = DiaMatrix.from_host_csr(Ht, device="cpu")
    else:
        At = convert.dia_from_arrays(np.asarray(Aj.diags), Aj.offsets,
                                     Aj.shape, device="cpu")
        assert At.ld >= At.n_rows
    y = tspmv.dia_spmv(At, torch.from_numpy(x)).numpy()
    _close(y, y_ref, RTOL[dtype])
    np.testing.assert_array_equal(
        y, tspmv.dia_spmv_torch(At, torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("shape", [(90, 90), (90, 130), (130, 90)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("source", ["host_csr", "jax_arrays"])
def test_ell_matches_jax(shape, dtype, source):
    rng = np.random.default_rng(4)
    dense = rng.standard_normal(shape) * (rng.random(shape) < 0.1)
    dense = dense.astype(dtype)
    Aj = jdev.EllMatrix.from_host_csr(jhost.HostCSR.from_dense(dense))
    x = rng.random(shape[1]).astype(dtype)
    y_ref = np.asarray(jspmv.ell_spmv_xla(Aj, jnp.asarray(x)))
    if source == "host_csr":
        At = EllMatrix.from_host_csr(HostCSR.from_dense(dense), device="cpu")
    else:
        At = convert.ell_from_arrays(np.asarray(Aj.data), np.asarray(Aj.cols),
                                     Aj.shape, Aj.n_cols_pad, device="cpu")
    y = tspmv.matvec(At, torch.from_numpy(x)).numpy()
    _close(y, y_ref, RTOL[dtype])
    _close(y, dense @ x, RTOL[dtype] * 10)


@pytest.mark.parametrize("bad", ["dtype", "length", "int_operator", "device"])
def test_dia_wrapper_refuses(bad):
    _, Ht, x = _pair("wide", np.float64)
    A = DiaMatrix.from_host_csr(Ht, device="cpu")
    x = torch.from_numpy(x)
    if bad == "dtype":
        with pytest.raises(TypeError):
            tspmv.dia_spmv(A, x.float())
    elif bad == "length":
        with pytest.raises(ValueError):
            tspmv.dia_spmv(A, x[:-1])
    elif bad == "int_operator":
        Ai = DiaMatrix(A.diags.long(), A.offsets, A.offsets_dev, A.shape)
        with pytest.raises(TypeError):
            tspmv.dia_spmv(Ai, x.long())
    else:
        with pytest.raises(ValueError):
            tspmv.dia_spmv(A, x.to("meta"))


def test_dia_container_validates():
    _, Ht, _ = _pair("square_5pt", np.float64)
    A = DiaMatrix.from_host_csr(Ht, device="cpu")
    assert A.offsets_dev.dtype == torch.int32
    assert A.offsets_dev.tolist() == list(A.offsets)
    with pytest.raises(ValueError):      # leading dimension below n_rows
        DiaMatrix(A.diags[:, :10], A.offsets, A.offsets_dev, A.shape)
    with pytest.raises(ValueError):      # offsets not int32
        DiaMatrix(A.diags, A.offsets, A.offsets_dev.long(), A.shape)


def test_cuda_build_refuses_without_nvcc(monkeypatch, tmp_path):
    from pysolvers_tpu_torch.ops import _cuda_build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda_build._nvcc()
