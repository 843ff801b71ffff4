"""Kernels K1, K2/K3, K4/K5, K6 and K7 and the port's main paths on a CUDA device,
against the plain twins and the CPU path.  Every test here needs the card and skips without
one; this file imports neither jax nor pysolvers_tpu, so it runs on a GPU
machine without JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance of K1 against its twin, relative to max|y|: 1e-6 in f32 and
1e-13 in f64 — K1 contracts each multiply-add into one FMA where the twin
rounds product and sum separately; both add the D terms in offset order.
K2/K3 against their twin, relative to max|y|: 1e-5 in f32 and 1e-12 in
f64 — the kernels sum a row's products over the device CSR (in column
order, or strided across up to 256 threads and then by shuffles), the
twin over the pack's segments in torch's reduction order.  K4/K5 against
their twins: K1's tolerances — K4 adds the (d, q) terms in the twin's
order, K5 in (q, d) order (a reordering of D·b terms, a few ulps of the
partial sums), both with FMAs.  K6 against its twin: K1's tolerances, for
the same reason (both add the D terms in pair order).  K7 is a pure
gather and must be bit-exact.
"""
import numpy as np
import pytest
import torch

import pysolvers_tpu_torch as pt
import pysolvers_tpu_torch.linear.amg as tamg
from pysolvers_tpu_torch import convert
import dataclasses

from pysolvers_tpu_torch.ops import bws_spmv as tbws
from pysolvers_tpu_torch.ops import probe, spmv
from pysolvers_tpu_torch.sparse.bws import BwsMatrix
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


BWS_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _rect(n_rows, n_cols, seed, ratio, per_row=3, heavy=0.0,
          per_heavy=24, spread=300):
    """Columns near row·ratio, like aggregation-ordered AMG transfers.  The
    first ``heavy`` share of the rows holds ``per_heavy`` entries within
    ``spread`` columns: their tiles need many segments (more than the
    slots of a row in one block, so they spill), the rest few, so the pack
    has several segment classes."""
    rng = np.random.default_rng(seed)
    per = np.where(np.arange(n_rows) < heavy * n_rows, per_heavy, per_row)
    rows = np.repeat(np.arange(n_rows), per)
    centers = (np.arange(n_rows) * ratio).astype(np.int64)
    width = np.repeat(np.where(per > per_row, spread, 3), per)
    cols = np.clip(np.repeat(centers, per)
                   + rng.integers(-width, width + 1), 0, n_cols - 1)
    return HostCSR.from_coo(rows, cols, rng.standard_normal(len(rows)),
                            (n_rows, n_cols))


def _spill():
    rng = np.random.default_rng(2)
    D = np.eye(600)
    D[5, :40] = rng.standard_normal(40) + 2.0
    D[300, 256:380] = rng.standard_normal(124)
    return HostCSR.from_dense(D)


def _long_rows():
    """Rows longer than a row-block window (1024 nonzeros): 3000, 1500 and
    1025 nonzeros, each a block of its own, among tridiagonal rows."""
    rng = np.random.default_rng(3)
    n = 3500
    D = np.diag(rng.standard_normal(n) + 4.0)
    D += np.diag(rng.standard_normal(n - 1), 1)
    D += np.diag(rng.standard_normal(n - 1), -1)
    D[1700, :3000] = rng.standard_normal(3000)
    D[10, 100:1600] = rng.standard_normal(1500)
    D[3000, 2400:3425] = rng.standard_normal(1025)
    return HostCSR.from_dense(D)


# name -> (host matrix builder, pack keyword arguments)
BWS_CASES = {
    "square_rcm": (lambda: pt.problems.fem_poisson_2d_unstructured(
        70, seed=3), {}),
    "tall": (lambda: _rect(5000, 1300, 0, 0.25), dict(use_rcm=False)),
    "wide": (lambda: _rect(1300, 5000, 1, 4.0, per_row=6),
             dict(use_rcm=False)),
    "spill": (_spill, dict(use_rcm=False)),
    "long_rows": (_long_rows, dict(use_rcm=False, group_rows=8)),
    "multi_class": (lambda: pt.problems.fem_poisson_2d_unstructured(
        100, seed=3), dict(use_rcm=False)),
    "classes_tall": (lambda: _rect(20000, 5000, 0, 0.25, heavy=0.25),
                     dict(use_rcm=False)),
    "classes_wide": (lambda: _rect(5000, 20000, 1, 4.0, heavy=0.25),
                     dict(use_rcm=False)),
    "classes_square": (lambda: _rect(20000, 20000, 2, 1.0, heavy=0.25),
                       dict(use_rcm=False)),
}
# the packs with several segment classes, which bws_spmv_by_class runs
K3_CASES = ["multi_class", "classes_tall", "classes_wide", "classes_square"]


def _bws_pack(case, dtype, device):
    build, kw = BWS_CASES[case]
    H = build()
    return H, BwsMatrix.from_host_csr(H, dtype=dtype, device=device, **kw)


@pytest.mark.parametrize("case", sorted(BWS_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k2_matches_twin(cuda, case, dtype):
    H, A = _bws_pack(case, dtype, cuda)
    _check_bws(H, A, dtype, cuda, "K2")


@pytest.mark.parametrize("case", K3_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k3_matches_twin(cuda, case, dtype):
    H, A = _bws_pack(case, dtype, cuda)
    assert len(A.s_classes) >= 2
    _check_bws(H, A, dtype, cuda, "K3")


def _class_launches(A):
    """K3 launches of one bws_spmv_by_class call: one per class with row
    blocks."""
    s = A.csr.class_starts
    return sum(1 for c in range(len(s) - 1) if s[c + 1] > s[c])


def _check_bws(H, A, dtype, cuda, path):
    x = torch.randn(A.n_cols, dtype=dtype, device=cuda)
    before = (tbws.bws_spmv_launches, tbws.bws_spmv_classes_launches)
    y = (tbws.bws_spmv if path == "K2" else tbws.bws_spmv_by_class)(A, x)
    torch.cuda.synchronize()
    after = (tbws.bws_spmv_launches, tbws.bws_spmv_classes_launches)
    if path == "K2":     # one launch per product, classes or not
        assert after == (before[0] + 1, before[1])
    else:
        assert after == (before[0], before[1] + _class_launches(A))
    assert y.shape == (A.n_rows,) and y.device == x.device
    assert _rel(y, tbws.bws_spmv_torch(A, x)) <= BWS_RTOL[dtype]
    # and against the host product, in the pack's ordering
    perm = A.perm.cpu().numpy()
    xh = x.cpu().double().numpy()
    if A.n_rows == A.n_cols:
        y_host = H.matvec(xh[np.argsort(perm)])[perm]
    else:
        y_host = H.matvec(xh)
    assert _rel(y.cpu().double(), torch.from_numpy(y_host)) \
        <= 10 * BWS_RTOL[dtype]


def test_k7_probe_is_bit_exact(cuda):
    rng = np.random.default_rng(0)
    x = rng.random((8, 128)).astype(np.float32)
    idx = rng.integers(0, 128, size=(8, 128)).astype(np.int16)
    before = probe.lane_gather_probe_launches
    out = probe.lane_gather_probe(torch.from_numpy(idx).to(cuda),
                                  torch.from_numpy(x).to(cuda))
    torch.cuda.synchronize()
    assert probe.lane_gather_probe_launches == before + 1
    probe.check_lane_indices(cuda)           # every index was in range
    want = np.take_along_axis(x, idx.astype(np.int64), axis=1)
    assert np.array_equal(out.cpu().numpy(), want)


def test_k7_reports_an_out_of_range_index_at_the_read_point(cuda):
    """K7 does no host check per call: a bad lane reads nothing, yields 0
    and sets the device flag, which check_lane_indices raises on (and
    clears).  Never a silent gather from outside the row."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.random((8, 128)).astype(np.float32)).to(cuda)
    idx = rng.integers(0, 128, size=(8, 128)).astype(np.int16)
    idx[2, 5], idx[7, 127] = -1, 128
    out = probe.lane_gather_probe(torch.from_numpy(idx).to(cuda), x)
    with pytest.raises(ValueError, match=r"\[0, 128\)"):
        probe.check_lane_indices(cuda)
    probe.check_lane_indices(cuda)           # cleared by the read
    out = out.cpu().numpy()
    assert out[2, 5] == 0.0 and out[7, 127] == 0.0
    ok = (idx >= 0) & (idx < 128)
    want = np.take_along_axis(x.cpu().numpy(),
                              np.where(ok, idx, 0).astype(np.int64), axis=1)
    assert np.array_equal(out[ok], want[ok])
    with pytest.raises(ValueError, match=r"\[0, 128\)"):   # CPU: eager
        probe.lane_gather_probe(torch.from_numpy(idx), x.cpu())


def test_pcg_bws_on_cuda_matches_cpu(cuda):
    A = pt.problems.fem_poisson_2d_unstructured(70, seed=3)
    Ap = A.permute_symmetric(BwsMatrix._rcm_perm(A))
    b = Ap.matvec(np.random.default_rng(7).normal(size=Ap.shape[0]))

    def run(device):
        A_bws = BwsMatrix.from_host_csr(Ap, dtype=np.float64, use_rcm=False,
                                        device=device)
        return pt.PCG(pt.CommonSolverArgs(maxiter=300, tau=1e-10),
                      precond=pt.AMG(num_iters=2, num_levels=3,
                                     smoother="jacobi", galerkin="host",
                                     matrix_format="bws"),
                      device=device).make_solver().solve((Ap, A_bws), b)

    tbws.bws_spmv_launches = tbws.bws_spmv_classes_launches = 0
    st = run(cuda)
    assert tbws.bws_spmv_launches > 0 and tbws.bws_spmv_classes_launches == 0
    ref = run("cpu")
    assert st.success and st.reason == ref.reason
    assert abs(st.iters - ref.iters) <= 1
    x, xr = st.soln.cpu().numpy(), ref.soln.numpy()
    assert np.linalg.norm(x - xr) / np.linalg.norm(xr) <= 1e-8


@pytest.mark.parametrize("case", ["square_rcm", "wide", "long_rows",
                                  "classes_tall"])
def test_bws_layout_on_cuda_equals_cpu(cuda, case):
    """The layout built on the card (searchsorted, unique, sorts there) is
    the one built from the same tables on the CPU, bit for bit."""
    from pysolvers_tpu_torch.sparse.bws import bws_device_csr
    H, A = _bws_pack(case, torch.float64, cuda)
    L = A.csr
    ref = bws_device_csr(BwsMatrix.from_numpy(
        *(getattr(A, f).cpu().numpy() for f in ("delta", "data", "lidx",
                                                "perm", "iperm", "base")),
        A.shape, A.win_blocks, A.group_rows, A.s_classes, A.gt,
        device="cpu"))
    for f in ("indptr", "indices", "values", "row_blocks", "class_blocks"):
        assert torch.equal(getattr(L, f).cpu(), getattr(ref, f)), f
    assert L.class_starts == ref.class_starts


def test_bws_on_cuda_never_runs_the_twin(cuda, monkeypatch):
    H, A = _bws_pack("multi_class", torch.float64, cuda)
    x = torch.randn(A.n_cols, dtype=torch.float64, device=cuda)
    want = tbws.bws_spmv_torch(A, x)
    monkeypatch.setattr(tbws, "bws_spmv_torch", lambda *a: (
        _ for _ in ()).throw(AssertionError("twin on CUDA")))
    assert _rel(pt.matvec(A, x), want) <= 1e-12
    assert _rel(tbws.bws_spmv_by_class(A, x), want) <= 1e-12
    with pytest.raises(ValueError, match="contiguous"):
        tbws.bws_spmv(A, torch.randn(2 * A.n_cols, dtype=torch.float64,
                                     device=cuda)[::2])
    # a CUDA matrix without its layout raises; nothing else runs it
    object.__setattr__(A, "csr", None)
    for fn in (tbws.bws_spmv, tbws.bws_spmv_by_class):
        with pytest.raises(ValueError, match="layout"):
            fn(A, x)


# K4/K5: (nb, b, offsets, nb_pad) of random nonsymmetric planes, nonzero
# also where i + off falls outside [0, nb), so only the per-dof mask passes
BDIA_CASES = {
    "b3_odd_nb": (1001, 3, (-37, -1, 0, 2, 37), 1024),
    "b5_pad_gt_nb": (4099, 5, (-64, -1, 0, 1, 64), 16384),
    "b2_reach_past_both_ends": (777, 2, (-900, -776, 0, 776, 900), 777),
    "b1": (5000, 1, (-3, 0, 7), 5120),
    # K5's widest register tile: at k = 16 the 8 dofs split into 2 groups
    "b8_register_pressure": (2000, 8, (-45, -1, 0, 1, 45), 2048),
    "b11_two_groups": (300, 11, (-2, 0, 2), 384),
}


def _bdia(case, dtype, device):
    nb, b, offsets, nb_pad = BDIA_CASES[case]
    rng = np.random.default_rng(len(case))
    planes = rng.standard_normal((len(offsets) * b, b, nb_pad))
    return convert.bdia_from_arrays(planes, offsets, (nb * b, nb * b), b,
                                    device=device).astype(dtype)


@pytest.mark.parametrize("case", sorted(BDIA_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k4_matches_twin(cuda, case, dtype):
    A = _bdia(case, dtype, cuda)
    x = torch.randn(A.n_cols, dtype=dtype, device=cuda)
    before = spmv.bdia_spmv_launches
    y = spmv.bdia_spmv(A, x)
    torch.cuda.synchronize()
    assert spmv.bdia_spmv_launches == before + 1
    assert y.shape == (A.n_rows,) and y.device == x.device
    assert _rel(y, spmv.bdia_spmv_torch(A, x)) <= RTOL[dtype]


def _check_k5(A, k, dtype, cuda):
    V = torch.randn(k, A.n_cols, dtype=dtype, device=cuda)
    before = spmv.bdia_spmm_launches
    Y = spmv.bdia_spmm_rows(A, V)
    torch.cuda.synchronize()
    # more than 16 rows are chunked: 20 rows are two launches
    assert spmv.bdia_spmm_launches == before + (k + 15) // 16
    assert Y.shape == (k, A.n_rows)
    assert _rel(Y, spmv.bdia_spmm_torch(A, V)) <= RTOL[dtype]


@pytest.mark.parametrize("k", [1, 5, 8, 16, 20])
@pytest.mark.parametrize("case", sorted(BDIA_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k5_matches_twin(cuda, case, dtype, k):
    _check_k5(_bdia(case, dtype, cuda), k, dtype, cuda)


@pytest.mark.parametrize("k", [1, 3, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k5_on_the_block_jacobi_operator(cuda, dtype, k):
    """The lockstep solve's other K5 operand: the D = 1 block-Jacobi
    inverse of the vector Laplacian."""
    from pysolvers_tpu_torch.linear.block_precond import (
        block_jacobi_bdia_matrix)
    H = pt.fd_vector_laplacian_2d(40, b=5, coupling=0.2)
    M = block_jacobi_bdia_matrix(pt.BdiaMatrix.from_host_csr(H, 5,
                                                             device=cuda))
    assert M.offsets == (0,)
    _check_k5(M.astype(str(dtype).split(".")[1]), k, dtype, cuda)


def _sync_free_calls(name, cuda):
    """One wrapper call of each kernel, its inputs made beforehand; returns
    (call, the launch counter's module and name, launches per call)."""
    from pysolvers_tpu_torch.ops import grid_spmv
    if name == "dia_spmv":
        A = DiaMatrix.from_host_csr(_banded(*CASES["square_5pt"]),
                                    device=cuda)
        x = torch.randn(A.n_cols, dtype=torch.float64, device=cuda)
        return lambda: spmv.dia_spmv(A, x), (spmv, "dia_spmv_launches"), 1
    if name.startswith("bws_spmv"):
        H, A = _bws_pack("multi_class", torch.float64, cuda)
        x = torch.randn(A.n_cols, dtype=torch.float64, device=cuda)
        if name == "bws_spmv_by_class":
            return (lambda: tbws.bws_spmv_by_class(A, x),
                    (tbws, "bws_spmv_classes_launches"), _class_launches(A))
        if name == "bws_spmv_without_classes":
            A = dataclasses.replace(A, s_classes=())
        return lambda: tbws.bws_spmv(A, x), (tbws, "bws_spmv_launches"), 1
    if name.startswith("bdia"):
        A = _bdia("b5_pad_gt_nb", torch.float64, cuda)
        if name == "bdia_spmv":
            x = torch.randn(A.n_cols, dtype=torch.float64, device=cuda)
            return (lambda: spmv.bdia_spmv(A, x),
                    (spmv, "bdia_spmv_launches"), 1)
        V = torch.randn(20, A.n_cols, dtype=torch.float64, device=cuda)
        return (lambda: spmv.bdia_spmm_rows(A, V),
                (spmv, "bdia_spmm_launches"), 2)
    if name == "grid_dia_spmv":
        A = _grid("random_300x1100_D9", torch.float64, cuda)
        x = torch.randn(A.n_cols, dtype=torch.float64, device=cuda)
        return (lambda: grid_spmv.grid_dia_spmv(A, x),
                (grid_spmv, "grid_dia_spmv_launches"), 1)
    idx = torch.randint(0, 128, (8, 128), dtype=torch.int16, device=cuda)
    x = torch.rand(8, 128, dtype=torch.float32, device=cuda)
    return (lambda: probe.lane_gather_probe(idx, x),
            (probe, "lane_gather_probe_launches"), 1)


@pytest.mark.parametrize("name", [
    "dia_spmv", "bws_spmv_with_classes", "bws_spmv_without_classes",
    "bws_spmv_by_class", "bdia_spmv", "bdia_spmm_rows", "grid_dia_spmv", "lane_gather_probe"])
def test_wrapper_never_syncs(cuda, name):
    """A kernel wrapper launches and returns: no host round trip, so a
    solver loop of products never waits on the card (torch raises on any
    synchronising call in sync-debug mode "error")."""
    call, (mod, counter), n = _sync_free_calls(name, cuda)
    torch.cuda.synchronize()
    before = getattr(mod, counter)
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
        call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert getattr(mod, counter) == before + 2 * n
    probe.check_lane_indices(cuda)


def test_solve_defaults_to_the_card(cuda):
    """No device argument: solve() runs on the current CUDA device, K1
    included."""
    H = pt.problems.fd_laplacian_2d(64)
    b = H.matvec(np.random.default_rng(8).random(H.shape[0]))
    spmv.dia_spmv_launches = 0
    # "auto" would pick IC at this size, which is not ported yet
    st = pt.solve(H, b, precond="amg", tau=1e-10)
    assert st.success and st.soln.device.type == "cuda"
    assert spmv.dia_spmv_launches > 0
    x = st.soln.cpu().numpy()
    assert np.linalg.norm(b - H.matvec(x)) / np.linalg.norm(b) <= 1e-9


def test_k4_k5_on_cuda_never_run_the_twins(cuda, monkeypatch):
    A = _bdia("b3_odd_nb", torch.float64, cuda)
    ref = spmv.bdia_spmm_torch
    monkeypatch.setattr(spmv, "bdia_spmm_torch", lambda *a: (
        _ for _ in ()).throw(AssertionError("twin on CUDA")))
    monkeypatch.setattr(spmv, "bdia_spmv_torch", lambda *a: (
        _ for _ in ()).throw(AssertionError("twin on CUDA")))
    x = torch.randn(A.n_cols, dtype=torch.float64, device=cuda)
    counts = (spmv.bdia_spmv_launches, spmv.bdia_spmm_launches)
    y = spmv.bdia_spmv(A, x)
    Y = spmv.bdia_spmm_rows(A, torch.stack([x, 2 * x]))
    torch.cuda.synchronize()
    assert (spmv.bdia_spmv_launches, spmv.bdia_spmm_launches) == (
        counts[0] + 1, counts[1] + 1)
    assert _rel(Y[1], 2 * ref(A, x[None])[0]) <= 1e-13
    assert _rel(y, Y[0]) <= 1e-13
    with pytest.raises(ValueError, match="contiguous"):
        spmv.bdia_spmv(A, torch.randn(2 * A.n_cols, dtype=torch.float64,
                                      device=cuda)[::2])


@pytest.mark.parametrize("precond", ["auto", "bmg"])
def test_solve_bdia_on_cuda_matches_cpu(cuda, precond):
    H = pt.problems.fd_vector_laplacian_2d(48, b=5, coupling=0.2)
    X = np.random.default_rng(5).random((H.shape[0], 3))
    B = np.stack([H.matvec(X[:, j]) for j in range(3)], axis=1)

    def run(device, b):
        A = pt.BdiaMatrix.from_host_csr(H, 5, device=device)
        return pt.solve(A, b, tau=1e-10, maxiter=2000, precond=precond)

    for b in (B[:, 0], B):
        spmv.bdia_spmv_launches = spmv.bdia_spmm_launches = 0
        st = run(cuda, b)
        assert (spmv.bdia_spmv_launches if b.ndim == 1
                else spmv.bdia_spmm_launches) > 0
        ref = run("cpu", b)
        assert st.success and st.reason == ref.reason
        assert abs(st.iters - ref.iters) <= 1
        x, xr = st.soln.cpu().numpy(), ref.soln.numpy()
        assert np.linalg.norm(x - xr) / np.linalg.norm(xr) <= 1e-8


# K6: (mr, mc, pairs) of grid tables, random and nonzero at every position
# (column and row edges included), so a kernel that indexes x flat or
# swaps the dimensions fails; the stencil cases come from assembly
_ALL_PAIRS = tuple((dr, dc) for dr in range(-2, 3) for dc in range(-8, 9))
GRID_CASES = {
    "random_13x37_D85": (13, 37, _ALL_PAIRS),
    "random_37x13_D85": (37, 13, _ALL_PAIRS),
    "random_1001x777_D85": (1001, 777, _ALL_PAIRS),
    "random_300x1100_D9": (300, 1100, tuple(
        (dr, dc) for dr in (-1, 0, 1) for dc in (-1, 0, 1))),
    # more row blocks than a launch grid holds: the kernel's row loop
    "random_600000x2_D3": (600000, 2, ((-1, 0), (0, 1), (1, -1))),
}


def _grid(case, dtype, device):
    from pysolvers_tpu_torch import convert
    mr, mc, pairs = GRID_CASES[case]
    rng = np.random.default_rng(len(case))
    G = rng.standard_normal((len(pairs), mr, mc))
    G = G.astype(np.float32 if dtype == torch.float32 else np.float64)
    return convert.grid_dia_from_arrays(G, pairs, (mr, mc), device=device)


def _grid_stencil(m, nine, dtype, device):
    from pysolvers_tpu_torch.ops.grid_spmv import GridDiaMatrix
    if nine:
        rng = np.random.default_rng(m)
        ii, jj = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
        g = ii * m + jj
        rows, cols, vals = [], [], []
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                ni, nj = ii + di, jj + dj
                ok = (ni >= 0) & (ni < m) & (nj >= 0) & (nj < m)
                rows.append(g[ok])
                cols.append((ni * m + nj)[ok])
                vals.append(rng.normal(size=int(ok.sum())))
        H = HostCSR.from_coo(np.concatenate(rows), np.concatenate(cols),
                             np.concatenate(vals), (m * m, m * m))
    else:
        H = pt.problems.fd_laplacian_2d(m)
    A = DiaMatrix.from_host_csr(H, dtype=dtype, device=device)
    return GridDiaMatrix.from_dia(A, (m, m))


def _check_k6(A, dtype, cuda):
    from pysolvers_tpu_torch.ops import grid_spmv
    x = torch.randn(A.n_cols, dtype=dtype, device=cuda)
    before = grid_spmv.grid_dia_spmv_launches
    y = grid_spmv.grid_dia_spmv(A, x)
    torch.cuda.synchronize()
    assert grid_spmv.grid_dia_spmv_launches == before + 1
    assert y.shape == (A.n_rows,) and y.device == x.device
    assert _rel(y, grid_spmv.grid_dia_spmv_torch(A, x)) <= RTOL[dtype]


@pytest.mark.parametrize("case", sorted(GRID_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k6_matches_twin(cuda, case, dtype):
    _check_k6(_grid(case, dtype, cuda), dtype, cuda)


@pytest.mark.parametrize("m,nine", [(17, False), (40, False), (24, True),
                                    (257, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k6_matches_twin_on_stencils(cuda, m, nine, dtype):
    _check_k6(_grid_stencil(m, nine, dtype, cuda), dtype, cuda)


def test_k6_on_cuda_never_runs_the_twin(cuda, monkeypatch):
    from pysolvers_tpu_torch.ops import grid_spmv
    A = _grid("random_13x37_D85", torch.float64, cuda)
    ref = grid_spmv.grid_dia_spmv_torch
    x = torch.randn(A.n_cols, dtype=torch.float64, device=cuda)
    want = ref(A, x)
    monkeypatch.setattr(grid_spmv, "grid_dia_spmv_torch", lambda *a: (
        _ for _ in ()).throw(AssertionError("twin on CUDA")))
    y = pt.matvec(A, x)
    torch.cuda.synchronize()
    assert _rel(y, want) <= 1e-13
    with pytest.raises(ValueError, match="contiguous"):
        grid_spmv.grid_dia_spmv(A, torch.randn(2 * A.n_cols,
                                               dtype=torch.float64,
                                               device=cuda)[::2])


@pytest.mark.parametrize("galerkin", ["host", "device"])
def test_gmg_solve_on_cuda_runs_k6(cuda, galerkin, monkeypatch):
    """PCG + grid GMG with the K6 threshold lowered, so that the probed
    levels of m >= 31 are GridDiaMatrix on the card, against the CPU."""
    from pysolvers_tpu_torch.linear import gmg_grid
    from pysolvers_tpu_torch.ops import grid_spmv
    monkeypatch.setattr(gmg_grid, "GRID_KERNEL_MIN_M", 31)
    m = 63
    H = pt.problems.fd_laplacian_2d(m)
    x_star = np.random.default_rng(4).random(H.shape[0])
    b = H.matvec(x_star)

    def run(device):
        return pt.PCG(pt.CommonSolverArgs(maxiter=100, tau=1e-10),
                      precond=pt.GMGPreconditionerType(
                          (m, m), num_iters=2, num_levels=4,
                          smoother="jacobi", galerkin=galerkin),
                      device=device).make_solver()

    grid_spmv.grid_dia_spmv_launches = spmv.dia_spmv_launches = 0
    solver = run(cuda)
    st = solver.solve(H, b)
    h = solver._formed_prec.state
    if galerkin == "device":
        assert isinstance(h.levels[-1].A_dev, grid_spmv.GridDiaMatrix)
        assert grid_spmv.grid_dia_spmv_launches > 0
    assert spmv.dia_spmv_launches > 0
    ref = run("cpu").solve(H, b)
    assert st.success and st.reason == ref.reason
    assert st.iters == ref.iters
    x, xr = st.soln.cpu().numpy(), ref.soln.numpy()
    assert np.linalg.norm(x - xr) / np.linalg.norm(xr) <= 1e-9
    assert np.linalg.norm(b - H.matvec(x)) / np.linalg.norm(b) <= 1e-9
