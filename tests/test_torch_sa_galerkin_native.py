"""SA's Galerkin stage in native O(nnz) passes, checked on the CPU:

* ``sa_coarsen``'s (P, R, A_c) with the native smoothed prolongator
  (``native.sa_prolongator``) and counting transpose
  (``native.csr_transpose``) is, bit for bit in indptr, indices and
  values, the numpy route's (``tentative_prolongator``,
  ``filtered_matrix``, ``smooth_prolongator``, the argsort transpose), the
  route with no native library at all (as ``PST_NO_NATIVE=1`` leaves it)
  and the JAX package's host ``sa_coarsen``: on fd5 (one thread and,
  above 200,000 nonzeros, several), the unstructured FEM shuffled and in
  RCM order, an anisotropic operator whose weak entries are lumped (with
  stored zeros), a handed-over ``level0``, a float32 input (numpy
  route) and a row that lumps with no stored diagonal (numpy route);
* ``HostCSR.transpose`` native against numpy on square, wide, tall,
  empty-row, empty-column and empty matrices, in the dtypes it takes and
  two it leaves to numpy;
* the port's library (``csrc/sa_setup.cpp``) builds and binds both
  passes, and one that cannot be built warns once and leaves numpy;
* the counters "amg.galerkin_levels" and "amg.native_galerkin_levels"
  and the span "amg.rap" nested in "amg.galerkin";
* whole builds: PCG + AMG(2, 4, "host", "bws") on a small FEM system and
  PCG + AMG(2, 6) on fd5 take the numpy route's iterations and answer;
* the benchmark's reader of ``amg_setup.native_galerkin_share``.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import pysolvers_tpu as pst
import pysolvers_tpu.linear.amg as jamg
import pysolvers_tpu_torch as pt
import pysolvers_tpu_torch.linear.amg as tamg
from pysolvers_tpu_torch.sparse.bws import BwsMatrix
from pysolvers_tpu_torch.sparse.host import HostCSR
from pysolvers_tpu_torch.utils import native
from pysolvers_tpu_torch.utils.timing import Timer

torch.set_num_threads(1)
TOL = 0.08


@pytest.fixture
def clean_timers():
    Timer.reset()
    yield
    Timer.reset()


def _fem(m=65, rcm=True):
    A = pt.problems.fem_poisson_2d_unstructured(m, seed=3)
    return A.permute_symmetric(BwsMatrix._rcm_perm(A)) if rcm else A


def _anisotropic(m=40, eps=0.01):
    """eps·(−∂xx) − ∂yy on an m × m grid: the x couplings fall below the
    strength threshold and are lumped; a few of them are stored zeros."""
    idx = np.arange(m * m).reshape(m, m)
    rows, cols, vals = [idx.ravel()], [idx.ravel()], \
        [np.full(m * m, 2.0 + 2.0 * eps)]
    for (a, b), w in (((idx[:, :-1], idx[:, 1:]), -eps),
                      ((idx[:-1, :], idx[1:, :]), -1.0)):
        for r, c in ((a, b), (b, a)):
            rows.append(r.ravel())
            cols.append(c.ravel())
            vals.append(np.full(r.size, w))
    A = HostCSR.from_coo(np.concatenate(rows), np.concatenate(cols),
                         np.concatenate(vals), (m * m, m * m))
    off = np.flatnonzero(A.indices == A.to_coo()[0] + 1)[::7]
    A.data[off] = 0.0
    return A


def _no_diagonal_row(m=15, row=37):
    """fd5 with one row's diagonal left out and its couplings made weak:
    ``filtered_matrix``'s general rebuild."""
    A = pt.problems.fd_laplacian_2d(m)
    rows, cols, vals = A.to_coo()
    keep = ~((rows == row) & (cols == row))
    vals = np.where(rows == row, 1e-3 * vals, vals)
    return HostCSR.from_coo(rows[keep], cols[keep], vals[keep], A.shape)


def _f32(A):
    return HostCSR(A.indptr, A.indices, A.data.astype(np.float32), A.shape)


def _same(X, Y):
    """Bit-equal CSR (indptr, indices, values and their dtype)."""
    return (tuple(X.shape) == tuple(Y.shape)
            and np.array_equal(X.indptr, Y.indptr)
            and np.array_equal(X.indices, Y.indices)
            and X.data.dtype == Y.data.dtype
            and np.array_equal(X.data.view(np.uint8),
                               Y.data.view(np.uint8)))


def _numpy_route(monkeypatch):
    monkeypatch.setattr(native, "sa_prolongator", lambda *a, **k: None)
    monkeypatch.setattr(native, "csr_transpose", lambda *a, **k: None)


def _no_library(monkeypatch):
    for lib, tried in (("_LIB", "_TRIED"), ("_SETUP_LIB", "_SETUP_TRIED")):
        monkeypatch.setattr(native, lib, None)
        monkeypatch.setattr(native, tried, True)


def _jax(A):
    from pysolvers_tpu.sparse.host import HostCSR as JaxCSR
    P, R, A_c = jamg.sa_coarsen(JaxCSR(A.indptr, A.indices, A.data,
                                       A.shape), TOL)
    return [HostCSR(M.indptr, M.indices, M.data, M.shape)
            for M in (P, R, A_c)]


# (name, matrix, whether the native pass builds P)
CASES = [
    ("fd5_63", lambda: pt.problems.fd_laplacian_2d(63), True),
    # above 200,000 nonzeros: the pass splits its rows over threads
    ("fd5_223", lambda: pt.problems.fd_laplacian_2d(223), True),
    ("fem_65_shuffled", lambda: _fem(rcm=False), True),
    ("fem_65_rcm", _fem, True),
    ("anisotropic", _anisotropic, True),
    ("float32", lambda: _f32(_fem(33)), False),
    ("no_diagonal_row", _no_diagonal_row, False),
]


# Each case against each reference, but float32 against no library: there
# the numpy SpGEMM accumulates in float32 where the library's accumulates
# in float64, before and after the native passes alike.
PAIRS = [(case, ref) for ref in ("numpy_route", "no_library", "jax")
         for case in CASES if (case[0], ref) != ("float32", "no_library")]


@pytest.mark.parametrize("case,reference", PAIRS,
                         ids=[f"{ref}-{case[0]}" for case, ref in PAIRS])
def test_sa_coarsen_bit_equal(case, reference, monkeypatch, clean_timers):
    _, make, native_p = case
    A = make()
    got = tamg.sa_coarsen(A, TOL)
    assert Timer.calls("amg.galerkin_levels") == 1
    assert Timer.calls("amg.native_galerkin_levels") == int(native_p)
    if reference == "jax":
        want = _jax(A)
    else:
        (_numpy_route if reference == "numpy_route" else _no_library)(
            monkeypatch)
        want = tamg.sa_coarsen(A, TOL)
        assert Timer.calls("amg.native_galerkin_levels") == int(native_p)
    for X, Y in zip(got, want):
        assert _same(X, Y)


def test_anisotropic_lumps_and_keeps_stored_zeros():
    """The anisotropic case reaches what it is there for: weak entries
    to lump, stored zeros among them."""
    A = _anisotropic()
    strong = tamg.strength_neighbors(A, TOL)[2]
    rows, cols, _ = A.to_coo()
    weak = ~strong & (rows != cols)
    assert weak.sum() > A.shape[0] and (A.data[weak] == 0.0).any()


def test_level0_handed_over_bit_equal(monkeypatch, clean_timers):
    A = _fem()
    strength = tamg.strength_neighbors(A, TOL)
    agg = tamg.build_aggregates(A, TOL, strength=strength)
    got = tamg.sa_coarsen(A, TOL, level0=(strength, agg))
    assert Timer.calls("amg.aggregate") == 0
    assert Timer.calls("amg.native_galerkin_levels") == 1
    _numpy_route(monkeypatch)
    want = tamg.sa_coarsen(A, TOL, level0=(strength, agg))
    for X, Y, Z in zip(got, want, _jax(A)):
        assert _same(X, Y) and _same(X, Z)


def test_native_pass_leaves_the_degenerate_row_to_numpy():
    A = _no_diagonal_row()
    s = tamg.strength_neighbors(A, TOL)
    agg = tamg.build_aggregates(A, TOL, strength=s)
    assert native.sa_prolongator(A.indptr, A.indices, A.data, s[2], agg,
                                 int(agg.max()) + 1, 2.0 / 3.0) is None
    B = pt.problems.fd_laplacian_2d(15)
    s = tamg.strength_neighbors(B, TOL)
    agg = tamg.build_aggregates(B, TOL, strength=s)
    assert native.sa_prolongator(B.indptr, B.indices, B.data, s[2], agg,
                                 int(agg.max()) + 1, 2.0 / 3.0) is not None


def test_setup_library_binds_both_passes():
    lib = native.get_setup_lib()
    assert lib is not None
    assert hasattr(lib, "sa_prolongator") and hasattr(lib, "csr_transpose")


def test_setup_library_that_cannot_be_built_warns_once(monkeypatch,
                                                       tmp_path,
                                                       clean_timers):
    monkeypatch.setattr(native, "_SETUP_LIB", None)
    monkeypatch.setattr(native, "_SETUP_TRIED", False)
    monkeypatch.setattr(native, "_SETUP_SRC", str(tmp_path / "absent.cpp"))
    monkeypatch.setattr(native, "_SETUP_SO", str(tmp_path / "lib.so"))
    monkeypatch.delenv("PST_NO_NATIVE", raising=False)
    A = pt.problems.fd_laplacian_2d(15)
    with pytest.warns(RuntimeWarning, match="numpy routes"):
        got = tamg.sa_coarsen(A, TOL)
    assert Timer.calls("amg.native_galerkin_levels") == 0
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert native.get_setup_lib() is None
        assert native.csr_transpose(A.indptr, A.indices, A.data,
                                    A.shape) is None
    monkeypatch.setattr(native, "_SETUP_LIB", None)
    monkeypatch.setattr(native, "_SETUP_TRIED", True)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", True)
    for X, Y in zip(got, tamg.sa_coarsen(A, TOL)):
        assert _same(X, Y)


def _random_csr(shape, density, dtype, seed, empty_rows=(), empty_cols=()):
    rng = np.random.default_rng(seed)
    mask = rng.random(shape) < density
    mask[list(empty_rows), :] = False
    mask[:, list(empty_cols)] = False
    r, c = np.nonzero(mask)
    vals = (rng.standard_normal(len(r)) * 10).astype(dtype)
    if np.dtype(dtype).kind == "c":
        vals = vals + 1j * rng.standard_normal(len(r))
    return HostCSR.from_coo(r, c, vals.astype(dtype), shape)


SHAPES = {
    "square": dict(shape=(60, 60), density=0.1),
    "wide": dict(shape=(17, 90), density=0.15),
    "tall": dict(shape=(90, 17), density=0.15),
    "empty_rows": dict(shape=(50, 50), density=0.2,
                       empty_rows=(0, 7, 8, 49)),
    "empty_cols": dict(shape=(50, 40), density=0.2,
                       empty_cols=(0, 13, 14, 39)),
    "zero_nnz": dict(shape=(12, 9), density=0.0),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int64,
                                   np.int32, np.complex128, np.bool_])
@pytest.mark.parametrize("kind", list(SHAPES))
def test_transpose_native_bit_equal(kind, dtype, monkeypatch):
    """4- and 8-byte numbers take the counting pass, other values the
    argsort; both give the argsort's arrays."""
    A = _random_csr(dtype=dtype, seed=len(kind), **SHAPES[kind])
    res = native.csr_transpose(A.indptr, A.indices, A.data, A.shape)
    assert (res is None) == (dtype in (np.complex128, np.bool_))
    got = A.transpose()
    monkeypatch.setattr(native, "csr_transpose", lambda *a, **k: None)
    want = A.transpose()
    assert _same(got, want)
    assert got.shape == A.shape[::-1]
    assert np.array_equal(got.to_dense(), A.to_dense().T)


def test_galerkin_counters_and_rap_span(clean_timers):
    """Every level counts once in "amg.galerkin_levels" and, where the
    native pass built P, in "amg.native_galerkin_levels"; "amg.rap" runs
    once a level inside "amg.galerkin" (on the trace's clock too)."""
    H = pt.problems.fd_laplacian_2d(40)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pt.AMG(num_levels=4, galerkin="host").form(H, device="cpu")
    assert Timer.calls("amg.galerkin") == 3
    assert Timer.calls("amg.galerkin_levels") == 3
    assert Timer.calls("amg.native_galerkin_levels") == 3
    assert Timer.calls("amg.rap") == 3
    assert 0.0 < Timer.total("amg.rap") <= Timer.total("amg.galerkin")
    spans = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in ("amg.galerkin", "amg.rap"):
            spans.setdefault(e.name(), []).append((e.start_ns(),
                                                   e.end_ns()))
    assert len(spans["amg.rap"]) == len(spans["amg.galerkin"]) == 3
    assert all(any(s0 <= s and e <= e0 for s0, e0 in spans["amg.galerkin"])
               for s, e in spans["amg.rap"])
    Timer.reset()
    tamg.sa_coarsen(_f32(H), TOL)
    assert Timer.calls("amg.galerkin_levels") == 1
    assert Timer.calls("amg.native_galerkin_levels") == 0
    assert Timer.calls("amg.rap") == 1


def _pcg(A, precond):
    b = A.matvec(np.random.default_rng(7).random(A.shape[0]))
    return pt.PCG(pt.CommonSolverArgs(maxiter=300, tau=1e-10),
                  precond=precond, device="cpu").make_solver().solve(A, b)


BUILDS = {
    "fem_amg_2_4_host_bws": (
        _fem, lambda: pt.AMG(num_iters=2, num_levels=4, galerkin="host",
                             matrix_format="bws")),
    "fd5_amg_2_6": (lambda: pt.problems.fd_laplacian_2d(63),
                    lambda: pt.AMG(num_iters=2, num_levels=6)),
}


@pytest.mark.parametrize("build", list(BUILDS))
def test_whole_build_keeps_its_iterations(build, monkeypatch, clean_timers):
    make, precond = BUILDS[build]
    A = make()
    st = _pcg(A, precond())
    assert st.success
    assert Timer.calls("amg.native_galerkin_levels") \
        == Timer.calls("amg.galerkin_levels") > 0
    _numpy_route(monkeypatch)
    ref = _pcg(A, precond())
    assert st.iters == ref.iters
    assert torch.equal(st.soln, ref.soln)


def test_whole_build_matches_jax_iterations():
    """fd5 PCG + AMG(2, 6): the JAX package's iteration count."""
    m = 63
    A = pt.problems.fd_laplacian_2d(m)
    b = A.matvec(np.random.default_rng(7).random(A.shape[0]))
    args = dict(maxiter=300, tau=1e-10)
    st = pt.PCG(pt.CommonSolverArgs(**args),
                precond=pt.AMG(num_iters=2, num_levels=6),
                device="cpu").make_solver().solve(A, b)
    sj = pst.PCG(pst.CommonSolverArgs(**args),
                 precond=pst.AMG(num_iters=2, num_levels=6)
                 ).make_solver().solve(pst.problems.fd_laplacian_2d(m), b)
    assert st.success and int(st.iters) == int(sj.iters)


def test_reader_native_galerkin_share(clean_timers):
    from solverbench.lib import spec as S
    read = S.metric_reader("amg_setup.native_galerkin_share")
    assert read(None) is None                # a program without the counters
    Timer.count("amg.galerkin_levels", 4)
    assert read(None) == 0.0
    Timer.count("amg.native_galerkin_levels", 3)
    assert read(None) == pytest.approx(75.0)
    Timer.reset()
    pt.AMG(num_levels=3, galerkin="host").form(
        pt.problems.fd_laplacian_2d(24), device="cpu")
    assert read(None) == 100.0
