"""Kernel K1 and the port's main path on a CUDA device, against the plain
twin and the CPU path.  Every test here needs the card and skips without
one; this file imports neither jax nor pysolvers_tpu, so it runs on a GPU
machine without JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance of K1 against its twin, relative to max|y|: 1e-6 in f32 and
1e-13 in f64 — K1 contracts each multiply-add into one FMA where the twin
rounds product and sum separately; both add the D terms in offset order.
"""
import numpy as np
import pytest
import torch

import pysolvers_tpu_torch as pt
import pysolvers_tpu_torch.linear.amg as tamg
from pysolvers_tpu_torch import convert
from pysolvers_tpu_torch.ops import spmv
from pysolvers_tpu_torch.sparse.device import DiaMatrix
from pysolvers_tpu_torch.sparse.host import HostCSR

pytestmark = pytest.mark.cuda

RTOL = {torch.float32: 1e-6, torch.float64: 1e-13}

CASES = {
    "square_5pt": ((4000, 4000), (-63, -1, 0, 1, 63)),
    "wide": ((3000, 3077), (-3, 0, 5, 80)),
    "tall": ((3077, 3000), (-80, -1, 0, 2)),
    "negative_only": ((2570, 2570), (-2000, -7, -1)),
    "wide_offsets": ((5000, 5000), (-4500, -99, -1, 0, 1, 99, 250, 300,
                                    4500)),
    "D1_diagonal": ((1230, 1230), (0,)),
    "D1_shifted": ((1230, 1400), (9,)),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel K1 has no CPU mode)")
    return torch.device("cuda")


def _banded(shape, offsets, seed=0):
    rng = np.random.default_rng(seed)
    n, nc = shape
    rows, cols = [], []
    for off in offsets:
        i = np.arange(max(0, -off), min(n, nc - off))
        rows.append(i)
        cols.append(i + off)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return HostCSR.from_coo(rows, cols, rng.standard_normal(len(rows)), shape)


def _rel(y, y_ref):
    return float((y - y_ref).abs().max() / y_ref.abs().max())


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_matches_twin(cuda, case, dtype):
    A = DiaMatrix.from_host_csr(_banded(*CASES[case]), dtype=dtype,
                                device=cuda)
    x = torch.rand(A.n_cols, dtype=dtype, device=cuda)
    before = spmv.dia_spmv_launches
    y = spmv.dia_spmv(A, x)
    torch.cuda.synchronize()
    assert spmv.dia_spmv_launches == before + 1
    assert y.shape == (A.n_rows,) and y.device == x.device
    assert _rel(y, spmv.dia_spmv_torch(A, x)) <= RTOL[dtype]


def test_k1_takes_a_padded_leading_dimension(cuda):
    """Tables converted from the JAX package are padded far past n_rows."""
    H = _banded(*CASES["wide"])
    A = DiaMatrix.from_host_csr(H, device="cpu")
    padded = np.zeros((A.diags.shape[0], 8192))
    padded[:, : A.ld] = A.diags.numpy()
    Ac = convert.dia_from_arrays(padded, A.offsets, A.shape, device=cuda)
    x = torch.rand(A.n_cols, dtype=torch.float64)
    y = spmv.dia_spmv(Ac, x.to(cuda)).cpu()
    assert _rel(y, spmv.dia_spmv_torch(A, x)) <= 1e-13


def test_k1_refuses_non_contiguous_x(cuda):
    A = DiaMatrix.from_host_csr(_banded(*CASES["square_5pt"]), device=cuda)
    x = torch.rand(2 * A.n_cols, dtype=torch.float64, device=cuda)[::2]
    with pytest.raises(ValueError, match="contiguous"):
        spmv.dia_spmv(A, x)


def test_v_cycle_on_cuda_matches_cpu(cuda):
    H = pt.problems.fd_laplacian_2d(48)
    mlh = tamg.build_sa_hierarchy(H, 3)
    hc = tamg.build_device_hierarchy(mlh, device=cuda)
    assert hc.smoother == "jacobi"          # the "auto" choice on CUDA
    h = tamg.build_device_hierarchy(mlh, "jacobi", device="cpu")
    rng = np.random.default_rng(0)
    f = torch.from_numpy(rng.standard_normal(48 * 48))
    x0 = torch.from_numpy(rng.standard_normal(48 * 48))
    y = tamg.v_cycle(hc, f.to(cuda), x0.to(cuda)).cpu()
    y_ref = tamg.v_cycle(h, f, x0)
    assert float(torch.linalg.norm(y - y_ref) / torch.linalg.norm(y_ref)) \
        <= 1e-12


def test_pcg_amg_on_cuda_matches_cpu(cuda):
    H = pt.problems.fd_laplacian_2d(64)
    b = H.matvec(np.random.default_rng(1).random(H.shape[0]))

    def run(device):
        return pt.PCG(pt.CommonSolverArgs(maxiter=200, tau=1e-10),
                      precond=pt.AMG(num_iters=2, num_levels=4,
                                     smoother="jacobi"),
                      device=device).make_solver().solve(H, b)

    spmv.dia_spmv_launches = 0
    st = run(cuda)
    assert spmv.dia_spmv_launches > 0
    ref = run("cpu")
    assert st.success and st.reason == ref.reason
    assert abs(st.iters - ref.iters) <= 1
    x, xr = st.soln.cpu().numpy(), ref.soln.numpy()
    assert np.linalg.norm(x - xr) / np.linalg.norm(xr) <= 1e-8


def test_solve_front_end_on_cuda(cuda):
    H = pt.problems.fd_laplacian_2d(40)
    x_star = np.random.default_rng(2).random(H.shape[0])
    b = H.matvec(x_star)
    spmv.dia_spmv_launches = 0
    st = pt.solve(H, b, precond="amg", tau=1e-10, device=cuda)
    assert st.success and spmv.dia_spmv_launches > 0
    x = st.soln.cpu().numpy()
    assert np.linalg.norm(b - H.matvec(x)) / np.linalg.norm(b) <= 1e-9
