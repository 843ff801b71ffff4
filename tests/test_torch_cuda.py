"""Kernels K1, K2/K3, K4/K5, K6, K7 and K8 and the port's main paths (GMRES,
ILU(t)/IC(t), the direct solve and the mixed-precision routes among
them) on a CUDA device,
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
gather and must be bit-exact.  K8 (the block-banded triangular solve)
against its twin, relative to max|x|: 1e-5 in f32 and 1e-12 in f64 — the
kernel sums each row's dot products by warp shuffles, the twin by torch's
matrix-vector products, and the recurrence carries each block's rounding
into the next (the factors here are well conditioned).
"""
import numpy as np
import pytest
import torch

import pysolvers_tpu_torch as pt
import pysolvers_tpu_torch.linear.amg as tamg
from pysolvers_tpu_torch import convert
import dataclasses

from pysolvers_tpu_torch.linear import ilu as tilu
from pysolvers_tpu_torch.ops import block_trisolve as tbt
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
    if name == "block_trisolve":
        plan = _k8_plan("convdiff63_U_256", torch.float64, cuda)
        b = torch.randn(plan.n, dtype=torch.float64, device=cuda)
        return (lambda: tbt.block_trisolve(plan, b),
                (tbt, "block_trisolve_launches"), 1)
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
    "bws_spmv_by_class", "bdia_spmv", "bdia_spmm_rows", "grid_dia_spmv", "lane_gather_probe",
    "block_trisolve"])
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
    # AMG: K1 on the fine level of every V-cycle
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


# ---------------------------------------------------------------------------
# GMRES, ILU(t)/IC(t) and the direct solve on the card
# ---------------------------------------------------------------------------

def _convdiff(m, seed=2):
    H = pt.fd_convection_diffusion_2d(m)
    x_star = np.random.default_rng(seed).random(H.shape[0])
    return H, x_star, H.matvec(x_star)


def _same_solve(st, ref, H, b, iters=1):
    assert st.success and st.reason == ref.reason
    assert st.soln.device.type == "cuda"
    assert abs(st.iters - ref.iters) <= iters
    x, xr = st.soln.cpu().numpy(), ref.soln.numpy()
    assert np.linalg.norm(x - xr) / np.linalg.norm(xr) <= 1e-8
    assert np.linalg.norm(b - H.matvec(x)) / np.linalg.norm(b) <= 1e-9


def _cpu_auto_is_block(monkeypatch):
    """"auto" as the card resolves it ("block"), on the CPU too, for the
    reference solves."""
    real = tilu._resolve_trisolve_mode
    monkeypatch.setattr(tilu, "_resolve_trisolve_mode",
                        lambda mode, device=None: "block" if mode == "auto"
                        else real(mode, device))


@pytest.mark.parametrize("orthog", ["mgs", "cgs2"])
def test_gmres_ilut_on_cuda_runs_k1_and_matches_cpu(cuda, orthog,
                                                     monkeypatch):
    """solve()'s nonsymmetric default (GMRES + ILUT, "auto" = block solves
    on the card) on a DiaMatrix: K1 for every product, K8 twice per
    apply, the CPU port's iterations in block mode."""
    H, x_star, b = _convdiff(63)
    spmv.dia_spmv_launches = tbt.block_trisolve_launches = 0
    st = pt.solve(H, b, tau=1e-10, orthog=orthog)
    # one product per iteration, one per cycle start, one true residual
    assert spmv.dia_spmv_launches == st.iters + 2
    # right preconditioning: one apply per iteration and one to form x
    assert tbt.block_trisolve_launches == 2 * (st.iters + 1)
    _cpu_auto_is_block(monkeypatch)
    _same_solve(st, pt.solve(H, b, tau=1e-10, orthog=orthog, device="cpu"),
                H, b)


def test_pcg_ic_on_cuda_matches_cpu(cuda, monkeypatch):
    H = pt.problems.fd_laplacian_2d(64)
    b = H.matvec(np.random.default_rng(3).random(H.shape[0]))
    spmv.dia_spmv_launches = tbt.block_trisolve_launches = 0
    st = pt.solve(H, b, tau=1e-10)
    assert spmv.dia_spmv_launches == st.iters + 1
    assert tbt.block_trisolve_launches > 0
    _cpu_auto_is_block(monkeypatch)
    _same_solve(st, pt.solve(H, b, tau=1e-10, device="cpu"), H, b)


@pytest.mark.parametrize("m,per_apply", [(15, 18), (63, 9)])
def test_jacobi_bws_sweeps_launch_k2(cuda, m, per_apply):
    """Each sweep product is one K2 launch on the strict factor's device
    CSR: 9 per factor with 10 sweeps (ILUT's L has no off-diagonal entry
    at m = 63 and needs none)."""
    H, x_star, b = _convdiff(m)

    def run(device):
        return pt.GMRES(pt.CommonSolverArgs(maxiter=400, tau=1e-10),
                        precond=pt.ILUTPreconditionerType(
                            trisolve_mode="jacobi_bws"),
                        flexible=True, device=device).make_solver().solve(H, b)

    tbws.bws_spmv_launches = 0
    st = run(cuda)
    # FGMRES: one apply per iteration, none to form x
    assert tbws.bws_spmv_launches == per_apply * st.iters
    _same_solve(st, run("cpu"), H, b, iters=2)


def test_jacobi_bws_raises_on_cuda_rather_than_degrade(cuda, monkeypatch):
    """A factor that does not pack as BWS, or has a zero pivot, raises on
    the card and names the factor; no torch sweep or level plan runs."""
    from pysolvers_tpu_torch.linear import ilu as tilu
    boom = lambda *a, **k: (_ for _ in ()).throw(AssertionError("degraded"))
    monkeypatch.setattr(tilu, "build_trisolve_plan", boom)
    n = 40_000                 # tridiagonal, first and last unknowns coupled
    rows = np.r_[np.arange(n), np.arange(1, n), np.arange(n - 1), 0, n - 1]
    cols = np.r_[np.arange(n), np.arange(n - 1), np.arange(1, n), n - 1, 0]
    vals = np.r_[np.full(n, 4.0), -np.ones(2 * (n - 1)), -1.0, -1.0]
    H = pt.HostCSR.from_coo(rows, cols, vals, (n, n))
    with pytest.raises(ValueError, match="the lower factor does not pack"):
        pt.ILUTPreconditionerType(trisolve_mode="jacobi_bws").form(
            H, device=cuda)
    U = pt.problems.fd_laplacian_2d(6).extract_upper()
    U.data[U.indptr[3]] = 0.0              # row 3's diagonal
    eye = pt.HostCSR.from_coo(np.arange(36), np.arange(36), np.ones(36),
                              (36, 36))
    with pytest.raises(ValueError, match="the upper factor has a zero "
                                         "pivot in row 3"):
        tilu._factor_apply(eye, U, True, "jacobi_bws", 10, np.float64,
                           torch.device(cuda))


def test_block_miss_raises_on_cuda(cuda, monkeypatch):
    """Where the block path does not apply on the card, nothing falls to
    torch's level loop or sweeps: an explicit "block" raises naming the
    modes to pass, and "auto" takes the K2 sweeps, which raise for a
    factor that does not pack."""
    from pysolvers_tpu_torch.linear import ilu as tilu
    boom = lambda *a, **k: (_ for _ in ()).throw(AssertionError("degraded"))
    monkeypatch.setattr(tilu, "build_trisolve_plan", boom)
    n = 40_000                 # tridiagonal, first and last unknowns coupled
    rows = np.r_[np.arange(n), np.arange(1, n), np.arange(n - 1), 0, n - 1]
    cols = np.r_[np.arange(n), np.arange(n - 1), np.arange(1, n), n - 1, 0]
    vals = np.r_[np.full(n, 4.0), -np.ones(2 * (n - 1)), -1.0, -1.0]
    H = pt.HostCSR.from_coo(rows, cols, vals, (n, n))
    with pytest.raises(ValueError, match="not banded enough.*"
                                         "trisolve_mode='level'"):
        pt.ICPreconditionerType(trisolve_mode="block").form(H, device=cuda)
    with pytest.warns(UserWarning, match="Jacobi/BWS sweeps"), \
            pytest.raises(ValueError, match="the lower factor does not pack"):
        pt.ILUTPreconditionerType().form(H, device=cuda)


def test_block_lane_gmres_launches_k4(cuda, monkeypatch):
    """The block lane's GMRES: K4 for every product.  Its scalar IC(t)
    factors in f32 and, in block mode ("auto" on the card), applies by K8
    in f64 plans of that factor: exact, so non-flexible GMRES converges."""
    _cpu_auto_is_block(monkeypatch)      # the scalar IC's reference solves
    H = pt.problems.fd_vector_laplacian_2d(32, b=5, coupling=0.2)
    b = H.matvec(np.random.default_rng(5).random(H.shape[0]))
    for precond in ("auto", "ic"):
        spmv.bdia_spmv_launches = tbt.block_trisolve_launches = 0
        st = pt.solve(pt.BdiaMatrix.from_host_csr(H, 5, device=cuda), b,
                      tau=1e-10, method="gmres", precond=precond)
        assert spmv.bdia_spmv_launches == st.iters + 2
        if precond == "ic":
            assert tbt.block_trisolve_launches == 2 * (st.iters + 1)
        ref = pt.solve(pt.BdiaMatrix.from_host_csr(H, 5, device="cpu"), b,
                       tau=1e-10, method="gmres", precond=precond)
        _same_solve(st, ref, H, b)
    st = pt.solve(pt.BdiaMatrix.from_host_csr(H, 5, device=cuda), b,
                  tau=1e-10, precond="ic")
    _same_solve(st, pt.solve(pt.BdiaMatrix.from_host_csr(H, 5, device="cpu"),
                             b, tau=1e-10, precond="ic"), H, b)


@pytest.mark.parametrize("form", ["host", "dia", "ell"])
def test_direct_on_cuda(cuda, form):
    H = pt.problems.fd_laplacian_2d(22)
    x_star = np.random.default_rng(6).random(H.shape[0])
    b = H.matvec(x_star)
    A = {"host": H,
         "dia": pt.DiaMatrix.from_host_csr(H, device=cuda),
         "ell": pt.EllMatrix.from_host_csr(H, device=cuda)}[form]
    st = pt.DefaultDirect().make_solver().solve(A, b)
    assert st.success and st.soln.device.type == "cuda"
    x = st.soln.cpu().numpy()
    assert np.linalg.norm(x - x_star) / np.linalg.norm(x_star) <= 1e-12
    if form == "host":
        st = pt.solve(H, b)           # n <= 500: the direct solve, on the card
        assert st.iters == 1 and st.soln.device.type == "cuda"


def test_new_routes_never_run_a_twin_on_cuda(cuda, monkeypatch):
    boom = lambda *a: (_ for _ in ()).throw(AssertionError("twin on CUDA"))
    for mod, name in ((spmv, "dia_spmv_torch"), (spmv, "bdia_spmm_torch"),
                      (spmv, "bdia_spmv_torch"), (tbws, "bws_spmv_torch"),
                      (tbt, "block_trisolve_torch")):
        monkeypatch.setattr(mod, name, boom)
    H, _, b = _convdiff(31)
    assert pt.solve(H, b, tau=1e-10).success
    assert pt.GMRES(pt.CommonSolverArgs(maxiter=300, tau=1e-10),
                    precond=pt.ILUTPreconditionerType(
                        trisolve_mode="jacobi_bws"),
                    flexible=True).make_solver().solve(H, b).success
    Hv = pt.problems.fd_vector_laplacian_2d(16, b=3, coupling=0.2)
    assert pt.solve(pt.BdiaMatrix.from_host_csr(Hv, 3, device=cuda),
                    Hv.matvec(np.ones(Hv.shape[0])), tau=1e-10,
                    method="gmres").success


def test_gmres_reads_the_host_once_per_iteration(cuda, monkeypatch):
    """Five more iterations, five more synchronizations (sync-debug
    warnings) and five more host reads: the Hessenberg column's."""
    import warnings
    from pysolvers_tpu_torch.linear import krylov
    H, _, b = _convdiff(31)
    A = pt.DiaMatrix.from_host_csr(H, device=cuda)
    bt = torch.as_tensor(b, device=cuda)
    reads = []
    real = krylov._host
    monkeypatch.setattr(krylov, "_host", lambda t: reads.append(1) or real(t))

    def syncs(maxiter, orthog):
        reads.clear()
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                _, st, _ = krylov.gmres_solve(lambda v: pt.matvec(A, v), bt,
                                              maxiter=maxiter, tau=1e-15,
                                              orthog=orthog)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        assert st.k == maxiter
        return sum("synchroniz" in str(x.message) for x in w), len(reads)

    for orthog in ("mgs", "cgs2"):
        s5, r5 = syncs(5, orthog)
        s10, r10 = syncs(10, orthog)
        assert s10 - s5 == 5 and r10 - r5 == 5


# ---------------------------------------------------------------------------
# Mixed precision: f32 inner solves on the kernels, the f64 oracle on them
# ---------------------------------------------------------------------------

def _mixed_case(route, cuda):
    """(host matrix, right-hand sides (n,) or (n, k), the solve, the kernel
    of the route) for a mixed-precision route on the card."""
    rng = np.random.default_rng(11)
    if route in ("dia", "bws"):
        H = (pt.problems.fd_laplacian_2d(64) if route == "dia" else
             pt.problems.fem_poisson_2d_unstructured(65, seed=3))
        b = H.matvec(rng.random(H.shape[0]))
        fmt = "auto" if route == "dia" else "bws"
        solver = pt.PCG(pt.CommonSolverArgs(maxiter=500, tau=1e-10),
                        precond=pt.AMG(num_iters=2, num_levels=3,
                                       matrix_format=fmt),
                        precision="mixed").make_solver()
        return H, b, lambda: solver.solve(H, b), solver, (
            "K1" if route == "dia" else "K2")
    H = pt.problems.fd_vector_laplacian_2d(32, b=5, coupling=0.2)
    A = pt.BdiaMatrix.from_host_csr(H, 5, device=cuda)
    k = 1 if route == "bdia" else 3
    B = np.stack([H.matvec(rng.random(H.shape[0])) for _ in range(k)], 1)
    b = B[:, 0] if k == 1 else B
    return H, b, lambda: pt.solve(A, b, tau=1e-10, maxiter=2000,
                                  precision="mixed"), None, (
        "K4" if k == 1 else "K5")


@pytest.mark.parametrize("route", ["dia", "bws", "bdia", "bdia_k3"])
def test_mixed_route_runs_f32_kernels_and_an_f64_oracle(cuda, route,
                                                        monkeypatch):
    """precision="mixed" on the card: the inner operator is f32 on its
    kernel (DIA/K1, the RCM-ordered BWS pack/K2, K4, K5), the oracle's
    launches are f64 on the same kernel, no twin runs, and the solution is
    f64 on the current CUDA device with a host residual within tau."""
    from pysolvers_tpu_torch.ops import _cuda_build
    boom = lambda *a: (_ for _ in ()).throw(AssertionError("twin on CUDA"))
    for mod, name in ((spmv, "dia_spmv_torch"), (spmv, "bdia_spmm_torch"),
                      (spmv, "bdia_spmv_torch"), (tbws, "bws_spmv_torch")):
        monkeypatch.setattr(mod, name, boom)
    H, b, run, solver, kernel = _mixed_case(route, cuda)
    _cuda_build.launches_by_dtype.clear()
    st = run()
    torch.cuda.synchronize()
    counts = _cuda_build.launches_by_dtype
    assert counts[kernel, "float32"] > 0 and counts[kernel, "float64"] > 0
    assert st.success and st.soln.dtype == torch.float64
    assert st.soln.device == torch.device("cuda", torch.cuda.current_device())
    X = st.soln.cpu().numpy().reshape(H.shape[0], -1)
    Bh = np.asarray(b).reshape(H.shape[0], -1)
    for j in range(X.shape[1]):
        assert (np.linalg.norm(Bh[:, j] - H.matvec(X[:, j]))
                <= 1e-10 * np.linalg.norm(Bh[:, j]))
    if solver is not None:
        A32, A64 = solver._mx["A32"], solver._mx["A64"]
        assert A32.dtype == torch.float32 and A64.dtype == torch.float64
        assert A32.device.type == A64.device.type == "cuda"
        fmt = pt.DiaMatrix if route == "dia" else pt.BwsMatrix
        assert isinstance(A32, fmt) and isinstance(A64, fmt)


def test_cg_solve_rr_reads_the_host_once_per_iteration(cuda, monkeypatch):
    """Without replacements (a long cadence, no drop trigger), ten more
    iterations cost ten more synchronizations and ten more host reads."""
    import warnings
    from pysolvers_tpu_torch.linear import krylov
    H = pt.problems.fd_laplacian_2d(64)
    A32 = pt.DiaMatrix.from_host_csr(H, dtype=np.float32, device=cuda)
    A64 = pt.DiaMatrix.from_host_csr(H, dtype=np.float64, device=cuda)
    b = torch.as_tensor(H.matvec(np.ones(H.shape[0])), device=cuda)
    reads = []
    real = krylov._host
    monkeypatch.setattr(krylov, "_host", lambda t: reads.append(1) or real(t))

    def syncs(maxiter):
        reads.clear()
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                _, st, _ = krylov.cg_solve_rr(
                    lambda v: pt.matvec(A32, v), b,
                    mv_hi=lambda v: pt.matvec(A64, v), maxiter=maxiter,
                    tau=1e-30, replace_every=1000, replace_drop=0.0)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        assert st.k == maxiter
        return sum("synchroniz" in str(x.message) for x in w), len(reads)

    s10, r10 = syncs(10)
    s20, r20 = syncs(20)
    assert s20 - s10 == 10 and r20 - r10 == 10


def test_gmg_f32_route_on_cuda_runs_k6(cuda, monkeypatch):
    """The f32 device-probed hierarchy with K6 on its fine levels (the
    threshold lowered to reach them at m = 127), cg_solve_rr with two
    V-cycles and K6 in f64 on the f64 grid table as the oracle."""
    import pysolvers_tpu_torch.linear.gmg_grid as tgg
    from pysolvers_tpu_torch.ops import _cuda_build
    from pysolvers_tpu_torch.ops.grid_spmv import GridDiaMatrix
    from pysolvers_tpu_torch.linear.krylov import cg_solve_rr
    monkeypatch.setattr(tgg, "GRID_KERNEL_MIN_M", 63)
    m = 127
    H = pt.problems.fd_laplacian_2d(m)
    b = H.matvec(np.random.default_rng(0).random(H.shape[0]))
    h = tgg.build_grid_hierarchy_device(
        pt.DiaMatrix.from_host_csr(H, dtype=np.float32, device=cuda), 4,
        (m, m), smoother="jacobi")
    assert h.A0_inv.dtype == torch.float32
    G64 = GridDiaMatrix.from_dia_device(
        pt.DiaMatrix.from_host_csr(H, dtype=np.float64, device=cuda), (m, m))
    vc2 = tgg.grid_vc_apply(2)
    A_f = h.levels[-1].A_dev
    _cuda_build.launches_by_dtype.clear()
    x, st, _ = cg_solve_rr(lambda v: pt.matvec(A_f, v),
                           torch.as_tensor(b, device=cuda),
                           mv_hi=lambda v: pt.matvec(G64, v), maxiter=200,
                           tau=1e-10, precond=lambda r: vc2(h, r),
                           hi_matvec=False)
    counts = _cuda_build.launches_by_dtype
    assert st.reason == 1 and x.dtype == torch.float64
    assert counts["K6", "float32"] > 0 and counts["K6", "float64"] > 0
    assert counts["K1", "float32"] > 0                 # the m <= 31 levels
    xh = x.cpu().numpy()
    assert np.linalg.norm(b - H.matvec(xh)) <= 1.01e-10 * np.linalg.norm(b)


# ---------------------------------------------------------------------------
# K8: the block-banded triangular solve
# ---------------------------------------------------------------------------

def _k8_band(n=5000):
    """A banded lower factor reaching back 3500 rows: p = 4 at bs = 1024,
    the widest plan K8 streams (one 32 KB row per chunk in f64)."""
    rng = np.random.default_rng(7)
    i = np.arange(n)
    rows = np.concatenate([i, i[1:], i[3500:]])
    cols = np.concatenate([i, i[:-1], i[:-3500]])
    vals = np.concatenate([4.0 + rng.random(n), rng.uniform(-1, 1, n - 1),
                           rng.uniform(-1, 1, n - 3500)])
    return HostCSR.from_coo(rows, cols, vals, (n, n))


def _k8_factor(name):
    """(factor, lower, unit diagonal, bs) of a K8 case: ILUT of the
    convection-diffusion operator (m = 15 keeps multipliers in L; m = 63
    and 255 are the solve paths' sizes, n = 3,969 and 65,025), IC of the
    5-point Laplacian (phase 17's m = 129, and m = 63) and of the block
    lane's node-major vector Laplacian (p = 2 at bs = 256), and a banded
    factor with p = 4 at bs = 1024."""
    kind, what, bs = name.rsplit("_", 2)
    if kind.startswith("convdiff"):
        L, U = tilu.ilut_factor(pt.fd_convection_diffusion_2d(
            int(kind[8:])), 1e-4)
        T = {"L": (L, True, True), "U": (U, False, False)}[what]
    elif kind == "band5000":
        T = (_k8_band(), True, False)
    else:
        H = (pt.problems.fd_laplacian_2d(int(kind[9:]))
             if kind.startswith("laplacian")
             else pt.problems.fd_vector_laplacian_2d(64, b=5, coupling=0.2))
        Lc = tilu.ict_factor(H, 1e-4)
        T = {"L": (Lc, True, False), "Lt": (Lc.transpose(), False, False)}[
            what]
    return (*T, int(bs))


# the paths' factors, then every geometry the cluster walk handles: p = 3
# (laplacian129 at bs = 64), p = 4 (laplacian129 at bs = 40, laplacian63
# at bs = 16, band5000 at bs = 1024), rows that are not 16-byte multiples
# (bs = 63, p = 3: cp.async per value in f32 and f64), bs not a multiple
# of the cluster (40, 63: the last CTAs own fewer rows or none), nb = 1
# (n < bs, p = 0: stage 1 alone), bs = 1024 (laplacian129: p = 1, nb = 17)
K8_CASES = ["convdiff15_L_64", "convdiff15_U_64", "convdiff15_L_256",
            "convdiff63_U_256", "convdiff255_U_256", "laplacian129_L_256",
            "laplacian129_Lt_256", "vector64_L_256", "vector64_Lt_256",
            "laplacian129_L_64", "laplacian129_Lt_64", "laplacian129_L_40",
            "laplacian129_Lt_40", "laplacian63_L_16", "laplacian63_Lt_16",
            "laplacian129_L_63", "laplacian129_Lt_63", "convdiff15_U_1024",
            "laplacian129_L_1024", "laplacian129_Lt_1024", "band5000_L_1024"]

# the block reach each case must have, so that a change of the factors
# cannot quietly drop a geometry
K8_REACH = {"laplacian129_L_64": 3, "laplacian129_L_40": 4,
            "laplacian63_L_16": 4, "laplacian129_L_63": 3,
            "convdiff15_U_1024": 0, "laplacian129_L_1024": 1,
            "band5000_L_1024": 4}


def _k8_plan(name, dtype, cuda):
    T, lower, unit, bs = _k8_factor(name)
    return tbt.build_block_trisolve_plan(
        T, lower, unit, bs=bs, dtype=str(dtype).split(".")[1], device=cuda)


@pytest.mark.parametrize("case", K8_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k8_matches_twin(cuda, case, dtype):
    plan = _k8_plan(case, dtype, cuda)
    assert plan.p == K8_REACH.get(case.replace("_Lt_", "_L_"), plan.p)
    b = torch.as_tensor(np.random.default_rng(0).standard_normal(plan.n),
                        dtype=torch.float64, device=cuda)
    before = tbt.block_trisolve_launches
    x = tbt.block_trisolve(plan, b)
    assert tbt.block_trisolve_launches == before + 1
    ref = tbt.block_trisolve_torch(plan, b)
    assert x.dtype == torch.float64 and bool(torch.isfinite(x).all())
    assert _rel(x, ref) <= (1e-5 if dtype == torch.float32 else 1e-12)


@pytest.mark.parametrize("case", ["convdiff255_U_256", "laplacian129_L_63",
                                  "band5000_L_1024", "convdiff63_U_256"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k8_is_one_launch_and_never_syncs(cuda, case, dtype):
    """One solve is one K8 launch (both stages from one C call: one count
    in block_trisolve_launches and in launches_by_dtype) and makes no host
    round trip, with bulk copies (bs = 256, 1024) and with cp.async per
    value (bs = 63); the cluster size is 16 or 8."""
    from pysolvers_tpu_torch.ops import _cuda_build
    plan = _k8_plan(case, dtype, cuda)
    b = torch.randn(plan.n, dtype=dtype, device=cuda)
    ref = tbt.block_trisolve_torch(plan, b)
    geo = tbt.k8_launch_geometry(plan)
    assert geo is None or geo.cluster in tbt.K8_CLUSTERS
    tbt.block_trisolve(plan, b)                   # builds K8
    torch.cuda.synchronize()
    before = tbt.block_trisolve_launches
    by_dtype = _cuda_build.launches_by_dtype["K8", str(dtype)[6:]]
    torch.cuda.set_sync_debug_mode("error")
    try:
        x = tbt.block_trisolve(plan, b)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert tbt.block_trisolve_launches == before + 1
    assert _cuda_build.launches_by_dtype["K8", str(dtype)[6:]] == by_dtype + 1
    assert _rel(x, ref) <= (1e-5 if dtype == torch.float32 else 1e-12)


@pytest.mark.parametrize("case", ["convdiff255_U_256", "laplacian129_L_63",
                                  "band5000_L_1024"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k8_on_a_cluster_of_8(cuda, case, dtype, monkeypatch):
    """The walk on 8 CTAs, the size K8 takes where the card does not fit a
    cluster of 16: twice the rows a CTA, other stages and chunks."""
    monkeypatch.setattr(tbt, "K8_CLUSTERS", (8,))
    monkeypatch.setattr(tbt, "_K8_GEOMETRY", {})
    plan = _k8_plan(case, dtype, cuda)
    assert tbt.k8_launch_geometry(plan).cluster == 8
    b = torch.as_tensor(np.random.default_rng(1).standard_normal(plan.n),
                        dtype=dtype, device=cuda)
    x = tbt.block_trisolve(plan, b)
    ref = tbt.block_trisolve_torch(plan, b)
    assert _rel(x, ref) <= (1e-5 if dtype == torch.float32 else 1e-12)


def _k8_shapes(itemsize):
    """(bs, p) over every bs the wrapper takes: p = 1 .. 4 and the largest
    p whose ring fits, and its half."""
    for bs in range(1, tbt.K8_MAX_BS + 1):
        p_max = tbt.K8_SHARED_BYTES // (bs * itemsize) - 1
        for p in sorted({1, 2, 3, 4, p_max, max(1, p_max // 2)}):
            if 1 <= p <= p_max:
                yield bs, p


@pytest.mark.parametrize("cluster", tbt.K8_CLUSTERS)
@pytest.mark.parametrize("itemsize", [4, 8])
def test_k8_geometry_fits_every_accepted_plan(cuda, itemsize, cluster):
    """The geometry the kernel works out for every plan shape the wrapper
    takes (bs <= 1024, (p + 1)·bs values within 48 KB): within the 227 KB
    a CTA may opt in to, every row of a step owned by exactly one CTA and
    streamed in exactly one chunk, a compute warp's rows within its lanes,
    at least two stages."""
    n = 0
    for bs, p in _k8_shapes(itemsize):
        g = tbt.k8_geometry(bs, p, itemsize, cluster)
        row_bytes = p * bs * itemsize
        assert g.cluster == cluster
        owned = np.zeros(bs, dtype=np.int64)
        for c in range(cluster):
            lo, hi = c * g.rows, min(bs, (c + 1) * g.rows)
            if lo >= hi:
                continue
            owned[lo:hi] += 1
            chunks = -(-(hi - lo) // g.rows_per_chunk)
            assert chunks <= g.chunks
        assert (owned == 1).all()
        assert 1 <= g.rows_per_chunk <= g.rows
        assert g.rows_per_chunk * row_bytes <= g.chunk_bytes
        assert g.chunk_bytes % 128 == 0
        assert 2 <= g.stages <= 16
        ring = (p + 1) * bs * itemsize
        assert g.stages * g.chunk_bytes + ring <= g.smem_bytes <= 227 * 1024
        assert g.bulk == (row_bytes % 16 == 0)
        assert g.vec in (1, 16 // itemsize)
        if g.vec > 1:
            assert g.rows % g.vec == bs % g.vec == g.rows_per_chunk \
                % g.vec == 0
        # 16 compute warps; a warp holds u of its rows, one a lane
        assert -(-g.rows // (g.vec * 16)) * g.vec <= 32
        n += 1
    assert n > 4 * tbt.K8_MAX_BS


def test_k8_geometry_of_the_paths(cuda):
    """Phase 16's U and phase 17's IC factors (bs = 256, p = 1) and the
    widest plan (bs = 1024, p = 4): the stages and chunks the kernel
    takes; shapes it cannot run are refused."""
    g = tbt.k8_geometry(256, 1, 8, 16)
    assert (g.rows, g.rows_per_chunk, g.chunks, g.stages, g.bulk, g.vec) == (
        16, 16, 1, 6, True, 2)
    assert g.chunk_bytes == 16 * 256 * 8          # 32 KB a step
    assert tbt.k8_geometry(256, 1, 4, 16).vec == 4
    g = tbt.k8_geometry(1024, 4, 8, 16)
    assert (g.rows, g.rows_per_chunk, g.chunks, g.stages) == (64, 1, 64, 5)
    g = tbt.k8_geometry(63, 3, 4, 16)             # odd rows: cp.async
    assert not g.bulk and g.rows == 4 and g.vec == 1
    g = tbt.k8_geometry(40, 4, 8, 16)             # CTAs 14 and 15 own none
    assert g.rows == 3 and g.rows * 14 > 40
    for bs, p, cluster in ((256, 0, 16), (256, 1, 32), (1024, 1, 1)):
        with pytest.raises(ValueError, match="no K8 stage 2"):
            tbt.k8_geometry(bs, p, 8, cluster)


def test_k8_never_runs_the_twin_and_raises_on_a_failed_build(cuda,
                                                             monkeypatch):
    """The block apply on the card goes through K8 only; a K8 that cannot
    be built raises instead of falling back."""
    from pysolvers_tpu_torch.ops import _cuda_build
    boom = lambda *a: (_ for _ in ()).throw(AssertionError("twin on CUDA"))
    monkeypatch.setattr(tbt, "block_trisolve_torch", boom)
    H, _, b = _convdiff(31)
    prec = pt.ILUTPreconditionerType().form(H, device=cuda)
    assert all(p.device.type == "cuda" for p in prec.state)
    tbt.block_trisolve_launches = 0
    prec.apply_any(torch.as_tensor(b, device=cuda))
    assert tbt.block_trisolve_launches == 2
    monkeypatch.setattr(tbt, "_K8_ENTRIES", {})
    monkeypatch.setattr(_cuda_build, "_LIBS", {})

    def no_nvcc(name):
        raise RuntimeError("nvcc failed")
    monkeypatch.setattr(_cuda_build, "build", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        prec.apply_any(torch.as_tensor(b, device=cuda))


def test_auto_block_on_cuda_warns_nothing_on_the_paths(cuda):
    """"auto" on the card runs block plans, with no degrade warning, on
    the banded solve paths (ILUT, IC, the block lane's IC)."""
    import warnings
    H, _, b = _convdiff(63)
    Hv = pt.problems.fd_vector_laplacian_2d(32, b=5, coupling=0.2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tbt.block_trisolve_launches = 0
        assert pt.solve(H, b, tau=1e-10).success
        assert pt.solve(pt.problems.fd_laplacian_2d(64), np.ones(4096),
                        tau=1e-10).success
        assert pt.solve(pt.BdiaMatrix.from_host_csr(Hv, 5, device=cuda),
                        Hv.matvec(np.ones(Hv.shape[0])), tau=1e-10,
                        precond="ic").success
    assert tbt.block_trisolve_launches > 0


# ---------------------------------------------------------------------------
# Newton (slice 9) and the scalar multi-RHS routes (slice 10's rest)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_jvp_matches_the_twins_jvp(cuda, dtype):
    """torch.func.jvp through K1's autograd.Function: the primal and the
    tangent are K1 launches (two per jvp), within K1's tolerance of the
    twin's own jvp; through Bratu's F the tangent is J·v."""
    p = pt.problems.Bratu2D(m=63, device=cuda,
                            dtype=np.float32 if dtype == torch.float32
                            else np.float64)
    g = torch.Generator(device=cuda).manual_seed(0)
    x, v = (torch.rand(p.n, dtype=dtype, device=cuda, generator=g)
            for _ in range(2))
    spmv.dia_spmv_launches = spmv.dia_spmv_jvp_launches = 0
    y, t = torch.func.jvp(lambda u: spmv.dia_spmv(p.A, u), (x,), (v,))
    assert spmv.dia_spmv_launches == 2 and spmv.dia_spmv_jvp_launches == 1
    yr, tr = torch.func.jvp(lambda u: spmv.dia_spmv_torch(p.A, u), (x,),
                            (v,))
    assert _rel(y, yr) <= RTOL[dtype] and _rel(t, tr) <= RTOL[dtype]
    _, t = torch.func.jvp(p.eval_f, (x,), (v,))
    Jv = spmv.dia_spmv(p.eval_j_dev(x), v)
    assert _rel(t, Jv) <= 10 * RTOL[dtype]


def test_jvp_through_a_kernel_without_function_raises(cuda):
    """Only K1 carries a tangent; any other kernel refuses a transformed
    tensor rather than compute on the twin."""
    H, A = _bws_pack("multi_class", torch.float64, cuda)
    x = torch.randn(A.n_cols, dtype=torch.float64, device=cuda)
    with pytest.raises(RuntimeError, match="data pointer"):
        torch.func.jvp(lambda u: tbws.bws_spmv(A, u), (x,), (x,))


def _newton_bratu(device, m=63, precision="native"):
    inner = pt.PCG(pt.CommonSolverArgs(maxiter=400, tau=1e-12),
                   precond=pt.AMG(num_iters=5, num_levels=2,
                                  smoother="jacobi"),
                   precision=precision, device=device)
    prob = pt.problems.Bratu2D(m=m, alpha=0.5, device=device)
    return pt.NewtonSolver(pt.SolverConfig(maxiter=30, tau=1e-12),
                           solver=inner, min_lin_tol=1e-6, freeze_prec=True,
                           device=device).solve(
        prob, torch.zeros(prob.n, dtype=torch.float64, device=device))


@pytest.mark.parametrize("precision", ["native", "mixed"])
def test_newton_bratu_on_cuda_matches_cpu(cuda, precision):
    spmv.dia_spmv_launches = 0
    st = _newton_bratu(cuda, precision=precision)
    assert spmv.dia_spmv_launches > 0
    ref = _newton_bratu("cpu", precision=precision)
    assert st.success and ref.success
    assert st.iters == ref.iters and st.reason == ref.reason
    assert st.soln.device.type == "cuda"
    assert _rel(st.soln.cpu(), ref.soln) <= 1e-8


def test_newton_krylov_on_cuda_matches_cpu(cuda):
    kw = dict(tau=1e-12, maxiter=30, inner_maxiter=300, method="cg",
              min_lin_tol=1e-8)
    runs = {}
    for dev in ("cpu", cuda):
        p = pt.problems.Bratu2D(m=31, device=dev)
        spmv.dia_spmv_jvp_launches = 0
        runs[str(dev)] = pt.nonlinear.newton_krylov_solve(
            p.eval_f, np.zeros(p.n), device=dev,
            **kw), spmv.dia_spmv_jvp_launches
    (xc, sc), _ = runs["cpu"]
    (x, s), jvps = runs[str(cuda)]
    assert s.reason == sc.reason == pt.StopReason.CONVERGED
    assert s.k == sc.k and abs(s.inner_total - sc.inner_total) <= s.k
    # one tangent launch per J·v: the inner CG's products and its start
    assert jvps >= s.inner_total
    assert _rel(x.cpu(), xc) <= 1e-10


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_matmat_on_a_cuda_bws_matrix_matches_the_twin(cuda, dtype):
    H, A = _bws_pack("multi_class", dtype, cuda)
    X = torch.randn(A.n_cols, 5, dtype=dtype, device=cuda)
    want = torch.stack([tbws.bws_spmv_torch(A, X[:, j].contiguous())
                        for j in range(5)], dim=1)
    tbws.bws_spmv_launches = 0
    Y = pt.matmat(A, X)
    assert tbws.bws_spmv_launches == 5
    assert _rel(Y, want) <= (1e-5 if dtype == torch.float32 else 1e-12)


def _syncs(fn):
    """(synchronizations, host reads through krylov._host) of fn()."""
    import warnings
    from pysolvers_tpu_torch.linear import krylov
    reads = []
    real = krylov._host
    krylov._host = lambda t: reads.append(1) or real(t)
    torch.cuda.synchronize()
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        krylov._host = real
    return sum("synchroniz" in str(x.message) for x in w), len(reads)


@pytest.mark.parametrize("solver", ["cg", "gmres"])
def test_multi_rhs_reads_the_host_once_per_iteration(cuda, solver):
    """Five more lockstep iterations, five more synchronizations."""
    H = pt.problems.fd_laplacian_2d(63)
    A = pt.DiaMatrix.from_host_csr(H, device=cuda)
    B = torch.rand(H.shape[0], 4, dtype=torch.float64, device=cuda)
    fn = pt.cg_solve_multi if solver == "cg" else pt.gmres_solve_multi

    def run(maxiter):
        _, st, _ = fn(lambda V: pt.matmat(A, V), B, maxiter=maxiter,
                      tau=1e-15)
        assert int(st.k.max()) == maxiter

    s5, _ = _syncs(lambda: run(5))
    s10, _ = _syncs(lambda: run(10))
    assert s10 - s5 == 5


@pytest.mark.parametrize("kw", [dict(method="cg"), dict(method="gmres"),
                                dict(method="cg", precision="mixed"),
                                dict(method="gmres", precision="mixed")])
def test_solve_multi_on_cuda_matches_cpu(cuda, kw, monkeypatch):
    """solve(A, B) on the card against the CPU run; its preconditioners
    ("auto": IC(t) or ILUT, block solves by K8 on the card; the CPU is
    patched to block mode too) and the solution stay on the card."""
    _cpu_auto_is_block(monkeypatch)
    H = (pt.problems.fd_laplacian_2d(40) if kw["method"] == "cg"
         else pt.fd_convection_diffusion_2d(40))
    B = np.stack([H.matvec(c) for c in
                  np.random.default_rng(2).random((3, H.shape[0]))], 1)
    tbt.block_trisolve_launches = 0
    st = pt.solve(H, B, tau=1e-10, **kw)
    assert tbt.block_trisolve_launches > 0
    ref = pt.solve(H, B, tau=1e-10, device="cpu", **kw)
    assert st.success and ref.success and st.soln.device.type == "cuda"
    assert abs(st.iters - ref.iters) <= max(1, ref.iters // 20)
    assert _rel(st.soln.cpu(), ref.soln) <= 1e-8


def test_solve_multi_mixed_unstructured_runs_k2(cuda):
    H = pt.problems.fem_poisson_2d_unstructured(64, seed=3)
    B = np.stack([H.matvec(c) for c in
                  np.random.default_rng(2).random((3, H.shape[0]))], 1)
    tbws.bws_spmv_launches = 0
    st = pt.solve(H, B, tau=1e-10, method="cg", precond="jacobi",
                  precision="mixed")
    assert st.success and tbws.bws_spmv_launches > 0
    for j in range(3):
        r = B[:, j] - H.matvec(st.soln[:, j].cpu().numpy())
        assert np.linalg.norm(r) <= 1e-9 * np.linalg.norm(B[:, j])
