"""The port's default device: the current CUDA device, never the CPU.

Every entry point that takes ``device`` resolves None through
``sparse/device.py::resolve_device``.  With a card that is the current
CUDA device; without one it raises a RuntimeError that names
``device="cpu"``, so a caller never solves on the CPU without asking.
These tests fake the card's presence or absence with monkeypatch, so they
run (and check the same thing) on any machine.
"""
import numpy as np
import pytest
import torch

import pysolvers_tpu_torch as pt
from pysolvers_tpu_torch import convert
from pysolvers_tpu_torch.ops import spmv
from pysolvers_tpu_torch.sparse.device import resolve_device

NO_CARD = 'device="cpu"'


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_none_is_the_current_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device(None) == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert resolve_device(None) == torch.device("cuda", 3)


def test_none_without_a_card_raises(no_card):
    with pytest.raises(RuntimeError, match=NO_CARD):
        resolve_device(None)


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu"), "cuda:1"])
def test_a_named_device_is_kept(no_card, device):
    assert resolve_device(device) == torch.device(device)


def _rhs(H):
    return H.matvec(np.random.default_rng(0).random(H.shape[0]))


def test_solve_without_device_raises_and_runs_nothing(no_card):
    """No card and no device: solve() raises before any product runs on
    the CPU."""
    H = pt.problems.fd_laplacian_2d(24)
    calls = []
    real = spmv.dia_spmv_torch
    spmv.dia_spmv_torch = lambda *a: calls.append(1) or real(*a)
    try:
        with pytest.raises(RuntimeError, match=NO_CARD):
            pt.solve(H, _rhs(H), precond="jacobi", tau=1e-10)
    finally:
        spmv.dia_spmv_torch = real
    assert calls == []
    st = pt.solve(H, _rhs(H), precond="jacobi", tau=1e-10, device="cpu")
    assert st.success and st.soln.device.type == "cpu"


def _fd(m=24):
    return pt.problems.fd_laplacian_2d(m)


def _vec():
    return pt.fd_vector_laplacian_2d(48, b=5, coupling=0.2)


# each entry point that takes a device, called without one
ENTRY_POINTS = {
    "solve_block_auto_route": lambda: pt.solve(_vec(), _rhs(_vec())),
    "PCG": lambda: pt.PCG(pt.CommonSolverArgs()),
    "PCG_solver": lambda: pt.api.PCGSolver(pt.CommonSolverArgs(),
                                           pt.IdentityPreconditionerType()),
    "AMGVCycle": lambda: pt.AMGVCycle(pt.CommonSolverArgs()),
    "GMGVCycle": lambda: pt.GMGVCycle(pt.CommonSolverArgs(), dims=(24, 24)),
    "as_device_matrix": lambda: pt.api.as_device_matrix(_fd()),
    "DiaMatrix.from_host_csr": lambda: pt.DiaMatrix.from_host_csr(_fd()),
    "EllMatrix.from_host_csr": lambda: pt.EllMatrix.from_host_csr(_fd()),
    "BwsMatrix.from_host_csr": lambda: pt.BwsMatrix.from_host_csr(_fd()),
    "BdiaMatrix.from_host_csr": lambda: pt.BdiaMatrix.from_host_csr(_vec(),
                                                                    5),
    "AMG.form": lambda: pt.AMG(num_levels=2).form(_fd()),
    "GMG.form": lambda: pt.GMGPreconditionerType((24, 24),
                                                 num_levels=2).form(_fd()),
    "Jacobi.form": lambda: pt.JacobiPreconditionerType().form(_fd()),
    "dia_from_arrays": lambda: convert.dia_from_arrays(
        np.ones((1, 32)), (0,), (32, 32)),
    "bdia_from_arrays": lambda: convert.bdia_from_arrays(
        np.ones((2, 2, 8)), (0,), (16, 16), 2),
    "grid_dia_from_arrays": lambda: convert.grid_dia_from_arrays(
        np.ones((1, 4, 4)), ((0, 0),), (4, 4)),
    "ell_from_arrays": lambda: convert.ell_from_arrays(
        np.ones((8, 1)), np.zeros((8, 1)), (8, 8), 8),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_without_device_raises(no_card, entry):
    with pytest.raises(RuntimeError, match=NO_CARD):
        ENTRY_POINTS[entry]()


def test_bdia_solve_stays_on_the_matrix_device(no_card):
    """A BdiaMatrix solves on its own device: no device argument needed."""
    H = pt.fd_vector_laplacian_2d(12, b=5, coupling=0.2)
    A = pt.BdiaMatrix.from_host_csr(H, 5, device="cpu")
    st = pt.solve(A, _rhs(H), tau=1e-10)
    assert st.success and st.soln.device.type == "cpu"
