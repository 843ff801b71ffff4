"""The port's PCG + geometric multigrid against the plain reference
(``tests/plain_gmg.py``: plain torch, float64, textbook transfers and
explicit Galerkin products) on seeded random inputs, through the
factory's device-only operand: a ``DiaMatrix`` handed to the solver with
no host matrix.  Also the refusals of that operand, the GMG spans and
counter, and the one fine table the solver and the V-cycle share."""
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import pysolvers_tpu_torch as pt
import pysolvers_tpu_torch.linear.gmg_grid as tgg
from pysolvers_tpu_torch.linear.preconditioner import (
    ChebyshevPreconditionerType, JacobiPreconditionerType)
from pysolvers_tpu_torch.ops.grid_spmv import GridDiaMatrix
from pysolvers_tpu_torch.sparse.host import HostCSR
from pysolvers_tpu_torch.utils.timing import Timer

sys.path.insert(0, os.path.dirname(__file__))
import plain_gmg as ref  # noqa: E402

torch.set_num_threads(1)

NUM_ITERS = 2
# one V-cycle level of the apply is 5 products and a few vector passes,
# each rounding at ~1e-16; 2 cycles over 4–5 levels are ≈ 40 such passes,
# summed in other orders than the reference's (the probed Galerkin
# products, the coarsest inverse against a dense solve): a few hundred
# float64 roundings
APPLY_RTOL = 1e-12
# κ(A) = cot²(πh/2) for the Poisson matrix (a ≡ 1) at m = 127; a cell
# coefficient within [0.5, 2] widens the spectrum by at most their ratio
KAPPA_POISSON_127 = 6639.6
TAU = 1e-10


def coefficient(m, kind):
    if kind == "one":
        return None
    rng = np.random.default_rng(1000 + m)
    return torch.as_tensor(rng.uniform(0.5, 2.0, size=(m + 1, m + 1)))


def port_operator(A_ref, dtype=np.float64):
    """The reference's matrix as the port's device DiaMatrix on the CPU,
    lowered through the port's HostCSR."""
    idx = A_ref.indices().numpy()
    H = HostCSR.from_coo(idx[0], idx[1], A_ref.values().numpy(),
                         tuple(A_ref.shape))
    return H, pt.DiaMatrix.from_host_csr(H, dtype=dtype, device="cpu")


def gmg(m, levels, **kw):
    return pt.GMGPreconditionerType((m, m), num_iters=NUM_ITERS,
                                    num_levels=levels, nu_pre=2, nu_post=2,
                                    smoother="jacobi", **kw)


def _rel_inf(y, y_ref):
    y, y_ref = y.double(), y_ref.double()
    return float((y - y_ref).abs().max() / y_ref.abs().max())


@pytest.mark.parametrize("kind", ["one", "random"])
@pytest.mark.parametrize("m,levels", [(63, 4), (127, 5)])
def test_one_apply_matches_the_plain_reference(m, levels, kind):
    a = coefficient(m, kind)
    A_ref = ref.operator(m, a)
    _, A = port_operator(A_ref)
    v = torch.as_tensor(np.random.default_rng(m).standard_normal(m * m))
    y_ref = ref.apply(ref.hierarchy(A_ref, m, levels), v, NUM_ITERS)
    prec = gmg(m, levels).form(None, A, device="cpu")
    assert _rel_inf(prec.apply_any(v), y_ref) <= APPLY_RTOL


@pytest.mark.parametrize("kind", ["one", "random"])
def test_a_float32_apply_misses_the_tolerance(kind):
    """The same apply in float32 is ≥ 1e4 times the tolerance away: the
    comparison tells the precision apart."""
    m, levels = 63, 4
    a = coefficient(m, kind)
    A_ref = ref.operator(m, a)
    _, A32 = port_operator(A_ref, np.float32)
    v = torch.as_tensor(np.random.default_rng(m).standard_normal(m * m))
    y_ref = ref.apply(ref.hierarchy(A_ref, m, levels), v, NUM_ITERS)
    prec = gmg(m, levels).form(None, A32, device="cpu")
    assert prec.state.A0_inv.dtype == torch.float32
    assert _rel_inf(prec.apply_any(v.float()), y_ref) >= 1e4 * APPLY_RTOL


@pytest.mark.parametrize("kind", ["one", "random"])
def test_whole_solves_match_the_plain_reference(kind):
    m, levels = 127, 5
    a = coefficient(m, kind)
    A_ref = ref.operator(m, a)
    _, A = port_operator(A_ref)
    x_star = torch.as_tensor(np.random.default_rng(7).random(m * m))
    b = ref._mv(A_ref, x_star)
    h = ref.hierarchy(A_ref, m, levels)
    x_ref, k_ref = ref.pcg(A_ref, b, lambda r: ref.apply(h, r, NUM_ITERS),
                           tau=TAU, maxiter=200)
    st = pt.PCG(pt.CommonSolverArgs(maxiter=200, tau=TAU),
                precond=gmg(m, levels, galerkin="auto"),
                device="cpu").make_solver().solve(A, b)
    assert st.success
    assert abs(st.iters - k_ref) <= 1
    kappa = KAPPA_POISSON_127 * (1.0 if a is None
                                 else float(a.max() / a.min()))
    for x in (st.soln, x_ref):
        err = float(torch.linalg.vector_norm(x - x_star)
                    / torch.linalg.vector_norm(x_star))
        assert err <= kappa * TAU


# ---------------------------------------------------------------------------
# the device-only operand and its refusals
# ---------------------------------------------------------------------------

def _dia(m=31):
    H = pt.problems.fd_laplacian_2d(m)
    b = H.matvec(np.random.default_rng(0).random(H.shape[0]))
    return H, pt.DiaMatrix.from_host_csr(H, device="cpu"), b


def _solver(precond):
    return pt.PCG(pt.CommonSolverArgs(maxiter=100, tau=TAU), precond=precond,
                  device="cpu").make_solver()


@pytest.mark.parametrize("galerkin", ["auto", "device"])
def test_a_device_only_operand_solves(galerkin):
    H, A, b = _dia()
    """"auto" resolves to the device probe where no host matrix comes,
    the CPU included: the same solve as a host operand's "device"."""
    st = _solver(gmg(31, 3, galerkin=galerkin)).solve(A, b)
    st_host = _solver(gmg(31, 3, galerkin="device")).solve(H, b)
    assert st.success and st.iters == st_host.iters
    np.testing.assert_array_equal(st.soln.numpy(), st_host.soln.numpy())


@pytest.mark.parametrize("precond", [
    pt.AMG(num_iters=2, num_levels=2), JacobiPreconditionerType(),
    ChebyshevPreconditionerType(),
    pt.GMGPreconditionerType((31, 31), num_levels=3, executor="sparse")],
    ids=["amg", "jacobi", "chebyshev", "gmg_sparse"])
def test_other_types_still_need_a_host_matrix(precond):
    _, A, b = _dia()
    assert not precond.forms_from_device(A)
    with pytest.raises(ValueError, match="preconditioner setup needs a "
                                         "HostCSR matrix"):
        _solver(precond).solve(A, b)


def test_a_host_galerkin_without_a_host_matrix_names_the_option():
    _, A, b = _dia()
    with pytest.raises(ValueError, match="galerkin='host'"):
        _solver(gmg(31, 3, galerkin="host")).solve(A, b)


def test_a_device_only_gmg_needs_a_dia_operator():
    H, A, _ = _dia()
    p = gmg(31, 3)
    assert p.forms_from_device(A)
    assert not p.forms_from_device(pt.EllMatrix.from_host_csr(H,
                                                              device="cpu"))


def test_form_takes_its_dtype_from_the_device_operator():
    H, _, _ = _dia()
    A32 = pt.DiaMatrix.from_host_csr(H, dtype=np.float32, device="cpu")
    h = gmg(31, 3).form(None, A32, device="cpu").state
    assert h.A0_inv.dtype == torch.float32
    assert all(L.dinv.dtype == torch.float32 for L in h.levels[1:])


# ---------------------------------------------------------------------------
# one fine table
# ---------------------------------------------------------------------------

def test_the_solver_and_the_v_cycle_hold_one_fine_table(monkeypatch):
    """With the grid-kernel threshold lowered, the probed levels are grid
    tables, and the fine level is the solver's own DIA operator."""
    monkeypatch.setattr(tgg, "GRID_KERNEL_MIN_M", 7)
    H, A, b = _dia()
    s = _solver(gmg(31, 3))
    assert s.solve(A, b).success
    h = s._formed_prec.state
    assert h.levels[-1].A_dev is A
    assert [type(L.A_dev) for L in h.levels[1:-1]] == [GridDiaMatrix]
    # a host operand with the device probe ("auto" on the card): the
    # solver's lowering is the hierarchy's fine level
    s = _solver(gmg(31, 3, galerkin="device"))
    s.freeze_matrix()
    assert s.solve(H, b).success
    _, A_dev = s._split_cache[1]
    fine = s._formed_prec.state.levels[-1].A_dev
    assert fine.diags.data_ptr() == A_dev.diags.data_ptr()


# ---------------------------------------------------------------------------
# spans and counter
# ---------------------------------------------------------------------------

@pytest.fixture
def clean_timers():
    Timer.reset()
    yield
    Timer.reset()


LEVELS = 3


def _frozen(A, b):
    s = _solver(gmg(31, LEVELS))
    assert s.solve(A, b).success
    s.freeze_matrix()
    s.freeze_prec()
    return s


def _intervals(prof, prefix="gmg."):
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(prefix):
            out.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    return out


def _inside(inner, outer):
    return sum(any(s0 <= s and e <= e0 for s0, e0 in outer)
               for s, e in inner)


def test_gmg_spans_under_the_profiler_count_and_nest(clean_timers):
    _, A, b = _dia()
    s = _frozen(A, b)
    Timer.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        st = s.solve(A, b)
    applies = st.iters + 1               # M(r0), then one per iteration
    assert Timer.calls("gmg.applies") == Timer.calls("gmg.apply") == applies
    for lvl in range(LEVELS):
        assert Timer.calls(f"gmg.level.{lvl}") == applies * NUM_ITERS
    spans = _intervals(prof)
    assert {n: len(v) for n, v in spans.items()} == {
        "gmg.apply": applies,
        **{f"gmg.level.{lvl}": applies * NUM_ITERS
           for lvl in range(LEVELS)}}
    top = f"gmg.level.{LEVELS - 1}"
    assert _inside(spans[top], spans["gmg.apply"]) == applies * NUM_ITERS
    for lvl in range(LEVELS - 1):
        assert _inside(spans[f"gmg.level.{lvl}"],
                       spans[f"gmg.level.{lvl + 1}"]) == applies * NUM_ITERS


def test_profiler_off_counts_applies_and_records_no_span(clean_timers):
    _, A, b = _dia()
    s = _frozen(A, b)
    Timer.reset()
    st = s.solve(A, b)
    assert Timer.calls("gmg.applies") == st.iters + 1
    assert not any(k.startswith("gmg.") for k in Timer._totals)


# ---------------------------------------------------------------------------
# the benchmark's readers of the GMG cell (solverbench/metrics)
# ---------------------------------------------------------------------------

def _run(iters, timers=None, trace=None, cfg=None, A=None):
    from solverbench.lib import spec as S
    from solverbench.lib.loop import Run
    return Run(cfg=cfg or {}, mix={}, A=A, setup_s=1.0, window_s=1.0,
               solves=[dict(wall_s=0.5, iters=k, success=True, traced=True)
                       for k in iters],
               timers=timers or {}, trace=trace, kernels=S.kernels(),
               checks={}, memory_peak_bytes=0, setup_parts={})


def _trace(busy_s, window_s, kernels=()):
    from solverbench.lib.trace import TraceSummary
    return TraceSummary(window_s=window_s, busy_s=busy_s,
                        kernel_names=[n for n, _ in kernels],
                        kernel_s=np.array([d for _, d in kernels]),
                        device_ops=[], idle_gaps=[])


def _read(name, run):
    from solverbench.lib import spec as S
    return S.metric_reader(name)(run)


def test_reader_gmg_apply_host_ms(clean_timers):
    run = _run([5], {"gmg.apply": 0.06})
    assert _read("gmg.apply_host_ms", run) is None     # no calls counted
    Timer._counts["gmg.apply"] = 6
    assert _read("gmg.apply_host_ms", run) == pytest.approx(10.0)
    assert _read("gmg.apply_host_ms", _run([5], {"amg.apply": 1.0})) is None


def test_reader_gmg_device_ms_per_iter_and_idle():
    run = _run([5, 5], trace=_trace(0.98, 1.0))
    assert _read("gmg.device_ms_per_iter", run) == pytest.approx(98.0)
    assert _read("device.idle.gmg", run) == pytest.approx(2.0)
    assert _read("gmg.device_ms_per_iter", _run([5])) is None
    assert _read("device.idle.gmg", _run([5])) is None


def test_reader_gmg_fine_roofline():
    """The fine products (5 iterations: 6 × 11 = 66) on K1 or K6 at twice
    their DIA bound (D from the configuration) read 50 %; shorter launches
    of coarser levels are not counted."""
    from solverbench.lib import roofline
    m = 63
    A = type("A", (), {"n": m * m, "nnz": 5 * m * m})()
    cfg = {"fine_diagonals": 5, "dtype": "float64",
           "solver": {"precond": {"num_iters": 2, "nu_pre": 2,
                                  "nu_post": 2}}}
    bound = roofline.spmv_bound_s("dia", A.n, A.nnz, 5)
    fine = ([("void dia_spmv_kernel<double>", 2 * bound)] * 30
            + [("void grid_dia_spmv_kernel<double>", 2 * bound)] * 36)
    coarse = [("void dia_spmv_kernel<double>", 0.1 * bound)] * 40
    run = _run([5], trace=_trace(1.0, 1.0, fine + coarse), cfg=cfg, A=A)
    assert roofline.fine_products(cfg["solver"]["precond"], 5) == 66
    assert _read("kernels.gmg_fine_roofline", run) == pytest.approx(50.0)
    short = _run([5], trace=_trace(1.0, 1.0, fine[:60]), cfg=cfg, A=A)
    assert _read("kernels.gmg_fine_roofline", short) is None
    assert _read("kernels.gmg_fine_roofline", _run(
        [5], trace=_trace(1.0, 1.0, fine), cfg={}, A=A)) is None
