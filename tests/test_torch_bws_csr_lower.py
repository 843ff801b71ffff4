"""An AMG hierarchy's BWS-lane matrices lowered straight to K2's layout
(``sparse/bws.py::lower_to_csr``: a ``BwsCsrMatrix`` where ``pack_fits``
holds), the one route on every device, checked on the CPU:

* the layout of every level and transfer of a small FEM SA hierarchy
  (``fem_poisson_2d_unstructured(65)``, RCM, AMG(2, 4)) is, bit for bit in
  indptr, indices and values, ``bws_device_csr`` of the JAX package's pack
  of the same matrix (``use_rcm=False``, ``group_rows`` 32 for square
  levels and auto for transfers, ``gt="auto"``), in f32 and f64; its row
  blocks keep ``row_block_table``'s budget; stored zeros are dropped and
  unsorted columns come out ascending;
* ``pack_fits`` is "``pack_arrays`` does not raise" on every matrix of
  that hierarchy, on square matrices whose window fits at some tiles and
  not at others (the cost model's pick decides), on a rectangular and a
  square matrix built to overflow the window, and on empty patterns;
* the hierarchy lowers every such matrix to the layout, counts
  "amg.csr_lowerings" and packs none, keeps the auto format where the
  pack would overflow, and its V-cycle and PCG solve agree with the auto
  format's and with the same hierarchy over packs;
* the products of the layout on the CPU (``bws_csr_spmv_torch`` through
  ``matvec``/``matmat``) against the host product, with no launch;
* the benchmark's reader of ``amg_setup.csr_lower_share``.
"""
import numpy as np
import pytest
import torch

import pysolvers_tpu_torch as pt
import pysolvers_tpu_torch.linear.amg as tamg
from pysolvers_tpu_torch.ops import bws_spmv as tbws
from pysolvers_tpu_torch.sparse.bws import (CSR_TILE_ROWS, ROW_BLOCK_WINDOW,
                                            BwsCsrMatrix, BwsMatrix,
                                            _ceil_to, _tile_windows,
                                            bws_device_csr, pack_arrays,
                                            pack_fits)
from pysolvers_tpu_torch.sparse.host import HostCSR
from pysolvers_tpu_torch.utils.timing import Timer

torch.set_num_threads(1)


@pytest.fixture
def clean_timers():
    Timer.reset()
    yield
    Timer.reset()


def _fem(m=65):
    A = pt.problems.fem_poisson_2d_unstructured(m, seed=3)
    return A.permute_symmetric(BwsMatrix._rcm_perm(A))


FEM = _fem()
MLH = tamg.build_sa_hierarchy(FEM, 4)
# every matrix of the hierarchy: (name, host matrix)
MATRICES = (
    [(f"A{k}", A) for k, A in enumerate(MLH.matrices)]
    + [(f"P{k}", P) for k, P in enumerate(MLH.prolongators)]
    + [(f"R{k}", R) for k, R in enumerate(MLH.restrictions)])
NAMES = [name for name, _ in MATRICES]


def _matrix(name):
    return dict(MATRICES)[name]


def _group_rows(H):
    """``device_matrix``'s geometry argument."""
    return 32 if H.shape[0] == H.shape[1] else None


def _pack(H, dtype):
    return BwsMatrix.from_host_csr(H, dtype=dtype, use_rcm=False,
                                   group_rows=_group_rows(H), gt="auto",
                                   device="cpu")


def _packs(H) -> bool:
    try:
        pack_arrays(H, np.float64, False, _group_rows(H), False, "auto")
    except ValueError:
        return False
    return True


def _assert_layout_is_the_packs(H, dtype):
    C = BwsCsrMatrix.from_host_csr(H, dtype=dtype, device="cpu")
    L = bws_device_csr(_pack(H, dtype))
    assert C.shape == tuple(H.shape) and C.dtype == L.values.dtype
    for f in ("indptr", "indices", "values"):
        a, b = getattr(C.csr, f), getattr(L, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    return C


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", NAMES)
def test_layout_is_the_packs_device_csr(name, dtype):
    _assert_layout_is_the_packs(_matrix(name), dtype)


@pytest.mark.parametrize("name", NAMES)
def test_row_blocks_keep_the_window_budget(name):
    """Every row in one block, every tile of ``CSR_TILE_ROWS`` rows starts
    a block, a block of several rows holds fewer than 2 · W nonzeros; no
    segment classes."""
    C = BwsCsrMatrix.from_host_csr(_matrix(name), dtype=np.float64,
                                   device="cpu")
    L = C.csr
    b = L.row_blocks.numpy().astype(np.int64)
    assert L.row_blocks.dtype == torch.int32
    assert b[0] == 0 and b[-1] == C.n_rows and np.all(np.diff(b) > 0)
    assert set(range(0, C.n_rows, CSR_TILE_ROWS)) <= set(b[:-1].tolist())
    ptr = L.indptr.numpy().astype(np.int64)
    nnz = ptr[b[1:]] - ptr[b[:-1]]
    assert np.all(nnz[np.diff(b) > 1] < 2 * ROW_BLOCK_WINDOW)
    assert L.class_blocks.numel() == 0 and L.class_starts == ()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stored_zeros_are_dropped(dtype):
    """Entries stored as 0, and an f64 value that is 0 in f32, leave the
    layout as they leave the pack's."""
    H = _matrix("A3")
    data = H.data.copy()
    data[::7] = 0.0
    data[3] = 1e-60                          # 0 in f32 only
    Z = HostCSR(H.indptr, H.indices, data, H.shape)
    C = _assert_layout_is_the_packs(Z, dtype)
    kept = int(np.count_nonzero(data.astype(dtype)))
    assert C.nnz == kept < H.nnz


def test_unsorted_columns_come_out_ascending():
    H = _matrix("P2")
    rng = np.random.default_rng(1)
    order = np.concatenate([
        H.indptr[i] + rng.permutation(H.indptr[i + 1] - H.indptr[i])
        for i in range(H.shape[0])])
    U = HostCSR(H.indptr, H.indices[order], H.data[order], H.shape)
    assert not all(np.all(np.diff(U.indices[U.indptr[i]:U.indptr[i + 1]]) > 0)
                   for i in range(U.shape[0]))
    C = BwsCsrMatrix.from_host_csr(U, dtype=np.float64, device="cpu")
    ref = BwsCsrMatrix.from_host_csr(H, dtype=np.float64, device="cpu")
    for f in ("indptr", "indices", "values", "row_blocks"):
        assert torch.equal(getattr(C.csr, f), getattr(ref.csr, f)), f


def _zigzag(n, ratio, period, heavy_every=0, heavy_blocks=64, n_cols=None):
    """Row i holds column ratio · (i mod period): a tile of T rows spans
    about ratio · T / 128 column blocks, so small tiles take a window that
    large ones overflow.  Every ``heavy_every``-th row also holds one entry
    in each of the next ``heavy_blocks`` column blocks: groups with many
    segments, which make the cost model pick smaller tiles."""
    n_cols = n_cols or n
    rows = np.arange(n)
    cols = ratio * (rows % period)
    R, C = [rows], [cols]
    if heavy_every:
        hr = np.arange(heavy_every // 2, n, heavy_every)
        for k in range(1, heavy_blocks):
            c = cols[hr] + 128 * k
            R.append(hr[c < n_cols])
            C.append(c[c < n_cols])
    R, C = np.concatenate(R), np.concatenate(C)
    return HostCSR.from_coo(R, C, np.ones(len(R)), (n, n_cols))


def _scattered(shape):
    """Row i holds column 7919 · i mod n: every tile spans every block."""
    i = np.arange(shape[0])
    return HostCSR.from_coo(i, 7919 * i % shape[1], np.ones(shape[0]), shape)


def _ends(shape):
    """Every row holds the first and the last column."""
    i = np.arange(shape[0])
    return HostCSR.from_coo(np.repeat(i, 2), np.tile([0, shape[1] - 1],
                                                     shape[0]),
                            np.ones(2 * shape[0]), shape)


def _empty(shape):
    return HostCSR(np.zeros(shape[0] + 1, dtype=np.int64),
                   np.zeros(0, dtype=np.int32), np.zeros(0), shape)


# name -> (host matrix, whether the pack is made): the hierarchy's
# matrices (all made), square ones whose window fits at small tiles only
# (the cost model's tile decides, either way), overflows and empty patterns
PREDICATE_CASES = {
    **{f"sa_{name}": (lambda name=name: _matrix(name), True)
       for name in NAMES},
    "zigzag_large_tile": (lambda: _zigzag(131072, 24, 4096), False),
    "zigzag_picks_64": (lambda: _zigzag(131072, 24, 4096, 4096, 16), True),
    "zigzag_picks_32": (lambda: _zigzag(131072, 24, 4096, 4096, 64), True),
    "zigzag_picks_16": (lambda: _zigzag(131072, 24, 4096, 1024, 64), True),
    "zigzag_picks_8": (lambda: _zigzag(131072, 24, 4096, 1024, 200), True),
    "zigzag_light_heavy": (lambda: _zigzag(131072, 24, 4096, 512, 16), False),
    "square_overflow": (lambda: _scattered((40000, 40000)), False),
    "wide_overflow": (lambda: _ends((3000, 100000)), False),
    "wide_fits": (lambda: _zigzag(4000, 20, 4000, n_cols=80000), True),
    "empty_square": (lambda: _empty((3000, 3000)), False),
    "empty_wide": (lambda: _empty((3000, 5000)), False),
    "all_stored_zeros": (lambda: HostCSR(
        _matrix("A3").indptr, _matrix("A3").indices,
        np.zeros(_matrix("A3").nnz), _matrix("A3").shape), True),
}


@pytest.mark.parametrize("case", sorted(PREDICATE_CASES))
def test_pack_fits_is_whether_the_pack_is_made(case):
    build, made = PREDICATE_CASES[case]
    H = build()
    assert _packs(H) == made
    assert pack_fits(H, _group_rows(H)) == made


def test_the_zigzag_cases_need_the_cost_model():
    """Where small tiles fit and large ones do not, the smallest tile the
    pack can choose at ``group_rows`` 32 (8 groups, 256 rows) takes a
    window and the pack may still refuse."""
    for case in ("zigzag_large_tile", "zigzag_light_heavy"):
        H = PREDICATE_CASES[case][0]()
        limit = max(256, _ceil_to(H.shape[1], 128) // 128 // 2)
        assert _tile_windows(H, [256])[256] <= limit
        assert not pack_fits(H, 32)
    picks = {case: pack_arrays(PREDICATE_CASES[case][0](), np.float64,
                               False, 32, False, "auto")["gt"]
             for case in ("zigzag_picks_64", "zigzag_picks_32",
                          "zigzag_picks_16", "zigzag_picks_8")}
    assert picks == {"zigzag_picks_64": 64, "zigzag_picks_32": 32,
                     "zigzag_picks_16": 16, "zigzag_picks_8": 8}


def _hierarchy(fmt="bws", dtype=np.float64):
    return tamg.build_device_hierarchy(MLH, "jacobi", dtype=dtype,
                                       device="cpu", matrix_format=fmt)


def _ops(h):
    return [op for L in h.levels[1:] for op in (L.A_dev, L.P_dev, L.R_dev)]


def _hosts(mlh):
    """The host matrices of ``_ops``, in its order."""
    return [M for k in range(1, mlh.n_levels) for M in (
        mlh.matrices[k], mlh.prolongators[k - 1], mlh.restrictions[k - 1])]


def _packed_counters():
    return [name for name, n in Timer._counts.items() if "pack" in name and n]


def test_cpu_hierarchy_lowers_every_bws_matrix(clean_timers):
    """On the CPU as on the card, every level and transfer of the BWS lane
    is K2's layout, counted by "amg.csr_lowerings"; nothing is packed."""
    h = _hierarchy()
    ops = _ops(h)
    lowered = [op for op in ops if isinstance(op, BwsCsrMatrix)]
    assert lowered and all(isinstance(op, BwsCsrMatrix)
                           == (max(op.shape) >= 2000) for op in ops)
    assert not any(isinstance(op, BwsMatrix) for op in ops)
    assert Timer.calls("amg.csr_lowerings") == len(lowered)
    assert Timer.calls("amg.csr_lower") == len(lowered)
    assert _packed_counters() == []


def test_card_rule_lowers_every_bws_matrix(clean_timers):
    """Each lowered level and transfer is, in indptr, indices and values,
    ``bws_device_csr`` of the pack the JAX package makes of its host
    matrix."""
    h = _hierarchy()
    pairs = [(op, M) for op, M in zip(_ops(h), _hosts(MLH))
             if isinstance(op, BwsCsrMatrix)]
    assert len(pairs) == Timer.calls("amg.csr_lowerings") > 0
    for op, M in pairs:
        assert op.shape == tuple(M.shape)
        L = bws_device_csr(_pack(M, np.float64))
        for f in ("indptr", "indices", "values"):
            assert torch.equal(getattr(op.csr, f), getattr(L, f))


def test_card_rule_keeps_the_auto_format_where_the_pack_overflows(
        clean_timers):
    """A level whose pack would overflow keeps the auto format (ELL); its
    transfers, which fit, are lowered."""
    n = 40000
    i = np.arange(n)
    H = HostCSR.from_coo(np.concatenate([i, i]),
                         np.concatenate([i, 7919 * i % n]),
                         np.full(2 * n, 0.5), (n, n))
    assert not pack_fits(H, 32) and not _packs(H)
    P = HostCSR.from_coo(i, i // 200, np.ones(n), (n, 200))
    mlh = tamg.MLHierarchy([HostCSR.eye(200), H], [P], [P.transpose()])
    h = tamg.build_device_hierarchy(mlh, "jacobi", dtype=np.float64,
                                    device="cpu", matrix_format="bws")
    assert isinstance(h.levels[1].A_dev, pt.EllMatrix)
    assert isinstance(h.levels[1].P_dev, BwsCsrMatrix)
    assert isinstance(h.levels[1].R_dev, BwsCsrMatrix)
    assert Timer.calls("amg.csr_lowerings") == 2     # P and R
    assert Timer.calls("amg.csr_lower") == 3         # A tested, not lowered


def test_card_rule_v_cycle_matches_the_packs():
    h = _hierarchy()
    ref = tamg.build_device_hierarchy(MLH, "jacobi", dtype=np.float64,
                                      device="cpu", matrix_format="auto")
    f = torch.from_numpy(np.random.default_rng(2).standard_normal(
        FEM.shape[0]))
    y = tamg.v_cycle(h, f, torch.zeros_like(f))
    y_ref = tamg.v_cycle(ref, f, torch.zeros_like(f))
    assert float((y - y_ref).abs().max()) <= 1e-12 * float(y_ref.abs().max())


@pytest.mark.parametrize("precision", ["native", "mixed"])
def test_card_rule_pcg_takes_the_packs_iterations(precision, monkeypatch,
                                                  clean_timers):
    """The lowered hierarchy against the same hierarchy over the JAX
    package's packs (the rule's layout swapped for the pack): the same
    iterations, answers within 1e-8."""
    b = FEM.matvec(np.random.default_rng(7).random(FEM.shape[0]))

    def run():
        return pt.PCG(pt.CommonSolverArgs(maxiter=300, tau=1e-10),
                      precond=pt.AMG(num_iters=2, num_levels=4,
                                     smoother="jacobi", galerkin="host",
                                     matrix_format="bws"),
                      precision=precision, device="cpu").make_solver().solve(
            FEM, b)

    st = run()
    assert Timer.calls("amg.csr_lowerings") > 0
    Timer.reset()
    packs = []

    def pack_instead(H, dtype, device):
        if not pack_fits(H, _group_rows(H)):
            return None
        packs.append(_pack(H, dtype))
        return packs[-1]

    monkeypatch.setattr(tamg, "lower_to_csr", pack_instead)
    ref = run()
    assert packs and Timer.calls("amg.csr_lowerings") == 0
    assert st.success and ref.success and st.iters == ref.iters
    x, xr = st.soln.numpy(), ref.soln.numpy()
    assert np.linalg.norm(x - xr) <= 1e-8 * np.linalg.norm(xr)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", ["A3", "P2", "R2"])
def test_cpu_products_of_the_layout(name, dtype):
    H = _matrix(name)
    C = BwsCsrMatrix.from_host_csr(H, dtype=dtype, device="cpu")
    rng = np.random.default_rng(3)
    X = rng.standard_normal((H.shape[1], 2))
    before = (tbws.bws_spmv_launches, tbws.bws_spmv_classes_launches)
    y = pt.matvec(C, torch.from_numpy(X[:, 0].astype(dtype)))
    Y = pt.matmat(C, torch.from_numpy(X.astype(dtype)))
    assert (tbws.bws_spmv_launches, tbws.bws_spmv_classes_launches) == before
    tol = 1e-5 if dtype == np.float32 else 1e-13
    want = np.stack([H.matvec(X[:, j]) for j in range(2)], 1)
    assert y.dtype == Y.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
    assert np.abs(y.numpy() - want[:, 0]).max() <= tol * np.abs(want).max()
    assert np.abs(Y.numpy() - want).max() <= tol * np.abs(want).max()
    with pytest.raises(TypeError, match="x is"):
        tbws.bws_spmv(C, torch.zeros(H.shape[1], dtype=torch.float16))
    with pytest.raises(ValueError, match="shape"):
        tbws.bws_spmv(C, torch.zeros(H.shape[1] + 1,
                                     dtype=C.dtype))


def test_reader_csr_lower_share(clean_timers):
    from solverbench.lib import spec as S
    read = S.metric_reader("amg_setup.csr_lower_share")
    assert read(None) is None                # a program without the counters
    Timer.count("amg.bws_packs", 6)
    assert read(None) == 0.0
    Timer.count("amg.csr_lowerings", 18)
    assert read(None) == pytest.approx(75.0)
    Timer.reset()
    Timer.count("amg.csr_lowerings", 5)
    assert read(None) == 100.0
