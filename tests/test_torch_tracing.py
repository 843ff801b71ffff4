"""The port's spans and its host-read counter (``utils/timing.py``,
``core.host_read``): what a CPU ``torch.profiler`` session sees of a
small PCG + AMG(2, 3) solve, what the same solve records with the
profiler off, the SA setup's split timers, the Chrome-trace exporter, and
the benchmark's readers of these spans on synthetic runs."""
import json
import os
import shutil

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import pysolvers_tpu_torch as pt
import pysolvers_tpu_torch.linear.amg as tamg
from pysolvers_tpu_torch.core import SolverConfig, make_status
from pysolvers_tpu_torch.linear import krylov
from pysolvers_tpu_torch.utils import profiling, timing
from pysolvers_tpu_torch.utils.timing import Timer

torch.set_num_threads(1)

TRACED_ONLY = ("krylov.cg", "krylov.cg_iter", "krylov.host_read",
               "amg.apply")
LEVELS, NUM_ITERS = 3, 2


def _problem(m=31):
    H = pt.problems.fd_laplacian_2d(m)
    return H, H.matvec(np.random.default_rng(0).random(H.shape[0]))


def _frozen_solver(H, b):
    """A PCG + AMG(2, 3) solver whose hierarchy is built and frozen."""
    s = pt.PCG(pt.CommonSolverArgs(maxiter=100, tau=1e-10),
               precond=pt.AMG(num_iters=NUM_ITERS, num_levels=LEVELS),
               device="cpu").make_solver()
    assert s.solve(H, b).success
    s.freeze_matrix()
    s.freeze_prec()
    return s


def _intervals(prof, prefix=("krylov.", "amg.")):
    """{name: [(start_ns, end_ns), ...]} of the program's spans in the
    profiler's kineto events."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(prefix):
            out.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    return out


def _inside(inner, outer):
    """How many intervals of ``inner`` lie within one of ``outer``."""
    return sum(any(s0 <= s and e <= e0 for s0, e0 in outer)
               for s, e in inner)


@pytest.fixture
def clean_timers():
    Timer.reset()
    yield
    Timer.reset()


def test_spans_under_the_profiler_count_and_nest(clean_timers):
    H, b = _problem()
    s = _frozen_solver(H, b)
    Timer.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        st = s.solve(H, b)
    assert st.success
    k = st.iters
    applies = k + 1                      # M(r0), then one per iteration
    assert Timer.calls("krylov.cg") == 1
    assert Timer.calls("krylov.cg_iter") == k
    assert Timer.calls("amg.apply") == applies
    for lvl in range(LEVELS):
        assert Timer.calls(f"amg.level.{lvl}") == applies * NUM_ITERS
    assert Timer.calls("krylov.host_read") == Timer.calls("host_reads") \
        == k + 3
    spans = _intervals(prof)
    assert {n: len(v) for n, v in spans.items()} == {
        "krylov.cg": 1, "krylov.cg_iter": k, "krylov.host_read": k + 3,
        "amg.apply": applies,
        **{f"amg.level.{lvl}": applies * NUM_ITERS
           for lvl in range(LEVELS)}}
    cg, it = spans["krylov.cg"], spans["krylov.cg_iter"]
    assert _inside(it, cg) == k
    # the first apply and the first stop read come before the loop
    assert _inside(spans["amg.apply"], cg) == applies
    assert _inside(spans["amg.apply"], it) == k
    assert _inside(spans["krylov.host_read"], cg) == k + 1
    assert _inside(spans["krylov.host_read"], it) == k
    top = f"amg.level.{LEVELS - 1}"
    assert _inside(spans[top], spans["amg.apply"]) == applies * NUM_ITERS
    for lvl in range(LEVELS - 1):
        assert _inside(spans[f"amg.level.{lvl}"],
                       spans[f"amg.level.{lvl + 1}"]) == applies * NUM_ITERS


def test_setup_spans_reach_the_trace(clean_timers):
    """Always-on timers open their annotation while the profiler runs,
    inside "amg.host_hierarchy" where they belong."""
    H, _ = _problem(24)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pt.AMG(num_levels=LEVELS, galerkin="host").form(H, device="cpu")
    spans = _intervals(prof, ("amg.",))
    host = spans["amg.host_hierarchy"]
    assert len(host) == 1 and len(spans["amg.device_lower"]) == 1
    for name in ("amg.aggregate", "amg.galerkin"):
        assert len(spans[name]) == LEVELS - 1
        assert _inside(spans[name], host) == LEVELS - 1
    assert _inside(spans["amg.coarse_inverse"], spans["amg.device_lower"]) \
        == 1


def test_profiler_off_records_no_traced_span(clean_timers, monkeypatch):
    """With the profiler off no annotation is made (always-on timers
    included) and no traced-only span is kept; the counter still counts."""
    entered = []
    real = timing.annotation
    monkeypatch.setattr(timing, "annotation",
                        lambda name: entered.append(name) or real(name))
    H, b = _problem()
    s = pt.PCG(pt.CommonSolverArgs(maxiter=100, tau=1e-10),
               precond=pt.AMG(num_iters=NUM_ITERS, num_levels=LEVELS),
               device="cpu").make_solver()
    st = s.solve(H, b)
    assert st.success and entered == []
    assert Timer.calls("amg.host_hierarchy") == 1
    recorded = set(Timer._counts) | set(Timer._totals)
    assert not any(n in TRACED_ONLY or n.startswith("amg.level.")
                   for n in recorded)
    # PCG: the stop reason before the loop and once per iteration; the
    # status: the residual and its history
    assert Timer.calls("host_reads") == st.iters + 3
    with profile(activities=[ProfilerActivity.CPU]):
        s.solve(H, b)
    assert entered and "krylov.cg" in entered


@pytest.mark.parametrize("solver", ["cg", "cg_multi", "status"])
def test_host_reads_match_the_documented_count(clean_timers, solver):
    H, b = _problem(20)
    A = pt.DiaMatrix.from_host_csr(H, device="cpu")
    bt = torch.as_tensor(b)
    if solver == "cg":
        _, st, _ = krylov.cg_solve(lambda v: pt.matvec(A, v), bt,
                                   maxiter=200, tau=1e-10)
        assert Timer.calls("host_reads") == st.k + 1
    elif solver == "cg_multi":
        B = torch.stack([bt, 2.0 * bt], 1)
        _, st, _ = krylov.cg_solve_multi(lambda V: pt.matmat(A, V), B,
                                         maxiter=200, tau=1e-10)
        # the lockstep test before the loop and once per iteration
        assert Timer.calls("host_reads") == int(st.k.max()) + 1
    else:
        x, st, hist = krylov.cg_solve(lambda v: pt.matvec(A, v), bt,
                                      maxiter=200, tau=1e-10)
        Timer.reset()
        out = make_status(x, st, SolverConfig(), history=hist)
        assert Timer.calls("host_reads") == 2
        assert out.resid == float(st.resid) and out.iters == st.k


def test_host_counts_every_read_it_makes(clean_timers):
    """``_host`` reads through the counted primitive: a 0-d tensor as a
    Python scalar, any other as numpy."""
    t = torch.arange(3.0)
    assert isinstance(krylov._host(t), np.ndarray)
    assert krylov._host(t.sum()) == 3.0
    assert krylov._host(t[0] < 1) is True
    assert Timer.calls("host_reads") == 3


def test_sa_split_timers_within_the_host_build(clean_timers):
    H, _ = _problem(40)
    pt.AMG(num_levels=4, galerkin="host").form(H, device="cpu")
    split = Timer.total("amg.aggregate") + Timer.total("amg.galerkin")
    assert 0.0 < split <= Timer.total("amg.host_hierarchy")
    assert Timer.calls("amg.aggregate") == Timer.calls("amg.galerkin") == 3
    # a level whose aggregates are handed over is not aggregated again
    Timer.reset()
    strength = tamg.strength_neighbors(H, 0.08)
    agg = tamg.build_aggregates(H, 0.08, strength=strength)
    tamg.sa_coarsen(H, 0.08, level0=(strength, agg))
    assert Timer.calls("amg.aggregate") == 0
    assert Timer.calls("amg.galerkin") == 1


def test_counter_and_report(clean_timers, capsys):
    Timer.count("host_reads")
    Timer.count("host_reads", 2)
    with Timer("unit"):
        pass
    assert Timer.calls("host_reads") == 3 and Timer.total("host_reads") == 0
    assert Timer.calls("unit") == 1 and Timer.calls("missing") == 0
    Timer.report()
    out = capsys.readouterr().out
    assert "host_reads" in out and "unit" in out
    assert "missing" not in Timer._counts


def test_trace_takes_a_fresh_directory_each_call():
    H, b = _problem(16)
    A = pt.DiaMatrix.from_host_csr(H, device="cpu")
    dirs = []
    for _ in range(2):
        with profiling.trace() as d:
            krylov.cg_solve(lambda v: pt.matvec(A, v), torch.as_tensor(b),
                            maxiter=50, tau=1e-8)
        dirs.append(d)
    assert dirs[0] != dirs[1]
    for d in dirs:
        with open(os.path.join(d, "trace.json")) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert {"krylov.cg", "krylov.cg_iter", "krylov.host_read"} <= names
        shutil.rmtree(d)


# ---------------------------------------------------------------------------
# the benchmark's readers of the spans (solverbench/metrics)
# ---------------------------------------------------------------------------

def _run(iters, timers, traced=None):
    from solverbench.lib.loop import Run
    traced = traced or [True] * len(iters)
    return Run(cfg={}, mix={}, A=None, setup_s=1.0, window_s=1.0,
               solves=[dict(wall_s=0.1, iters=k, success=True, traced=t)
                       for k, t in zip(iters, traced)],
               timers=timers, trace=None, kernels=[], checks={},
               memory_peak_bytes=0, setup_parts={})


def _read(name, run):
    from solverbench.lib import spec as S
    return S.metric_reader(name)(run)


def test_reader_host_reads_per_iter(clean_timers):
    run = _run([11, 11], {})
    assert _read("krylov.host_reads_per_iter", run) is None
    Timer.count("host_reads", 28)
    assert _read("krylov.host_reads_per_iter", run) == pytest.approx(28 / 22)
    assert _read("krylov.host_reads_per_iter", _run([], {})) is None


def test_reader_host_wait_share():
    run = _run([11], {"krylov.cg": 0.2, "krylov.host_read": 0.01})
    assert _read("krylov.host_wait_share", run) == pytest.approx(5.0)
    assert _read("krylov.host_wait_share", _run([11], {})) is None


def test_reader_apply_ms(clean_timers):
    run = _run([11], {"amg.apply": 0.09})
    assert _read("precond.apply_ms", run) is None      # no calls counted
    Timer._counts["amg.apply"] = 12
    assert _read("precond.apply_ms", run) == pytest.approx(7.5)


def test_reader_coarse_share():
    timers = {"amg.level.0": 0.001, "amg.level.4": 0.6, "amg.level.5": 0.8,
              "amg.level.x": 9.0, "amg.apply": 1.0}
    assert _read("precond.coarse_share", _run([11], timers)) == \
        pytest.approx(75.0)
    assert _read("precond.coarse_share", _run([11], {
        "amg.level.0": 0.1})) is None
    assert _read("precond.coarse_share", _run([11], {})) is None


def test_readers_of_the_sa_split():
    run = _run([11, 11], {"amg.device_aggregate": 0.4, "amg.aggregate": 0.2,
                          "amg.galerkin": 3.0, "amg.host_hierarchy": 3.5})
    assert _read("amg_setup.aggregate_s", run) == pytest.approx(0.3)
    assert _read("amg_setup.galerkin_s", run) == pytest.approx(1.5)
    # a program without the split: nothing to read
    old = _run([11], {"amg.device_aggregate": 0.4,
                      "amg.host_hierarchy": 3.5})
    assert _read("amg_setup.aggregate_s", old) is None
    assert _read("amg_setup.galerkin_s", old) is None
