"""Whole runs at small sizes on the CPU (the chip's look skipped): sound
runs come out correct; the control (the program's own float32 route) and
a timed path broken underneath come out not correct."""
import json

import pytest
import torch

from solverbench import run as cli
from solverbench.lib import spec as S

from .helpers import small_run

CELLS = [w["name"] for w in S.load_spec()["workloads"]]


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, never at
    import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    r = small_run(cell)
    assert r.correct, r.checks
    assert r.solves and r.failed == 0
    assert set(r.checks) == {"resid_max", "err_max", "failed_solves"}
    out = cli.result(S.load_spec(), cell, r, False, "cpu")
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    e2e = {m["name"] for m in S.cell_metrics(S.load_spec(), cell,
                                             "end_to_end")}
    assert set(out["metrics"]) == e2e
    json.dumps(out)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    """The same route in float32: it cannot reach tau = 1e-10, and its
    answers fail the residual's limit."""
    r = small_run(cell, dtype="float32", max_solves=2)
    assert not r.correct
    assert r.checks["resid_max"]["value"] > r.checks["resid_max"]["limit"]


def _broken(monkeypatch, fault):
    from pysolvers_tpu_torch.api import PCGSolver
    solve = PCGSolver.solve

    def broken(self, A, b):
        st = solve(self, A, b)
        if fault == "unchanged":
            st.soln = torch.zeros_like(st.soln)     # x0 handed back
        else:
            st.soln = st.soln.clone()
            st.soln[st.soln.numel() // 2] += 1e-3   # one entry altered
        return st
    monkeypatch.setattr(PCGSolver, "solve", broken)


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    _broken(monkeypatch, fault)
    r = small_run(cell)
    assert not r.correct
    assert r.checks["resid_max"]["value"] > r.checks["resid_max"]["limit"]


def test_run_refuses_jax_loaded_while_the_result_is_built(monkeypatch,
                                                         capsys):
    """A module planted while a metric reader loads (after the window has
    closed) still keeps the result line from being printed."""
    import sys
    cell = "fd5_poisson_1M.resolve"
    r = small_run(cell, max_solves=2)
    for name in list(sys.modules):
        if name.split(".")[0] in cli.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    assert cli.emit(S.load_spec(), cell, r, False, "cpu") == 0
    assert capsys.readouterr().out.strip().startswith('{"correct"')
    reader = S.metric_reader

    def planting(name):
        monkeypatch.setitem(sys.modules, "jax", object())
        return reader(name)
    monkeypatch.setattr(S, "metric_reader", planting)
    assert cli.emit(S.load_spec(), cell, r, False, "cpu") != 0
    captured = capsys.readouterr()
    assert captured.out == "" and "jax" in captured.err


def test_a_traced_run_reads_its_per_layer_metrics():
    cell = "fd5_poisson_1M.fresh_jacobian"
    r = small_run(cell, trace=True)
    out = cli.result(S.load_spec(), cell, r, True, "cpu")
    assert r.correct and r.trace is not None
    # the CPU runs no kernel: only the program's timers are read
    assert set(out["metrics"]) == {"amg_setup.host_s", "amg_setup.lower_s"}
    assert out["device"]["window_s"] > 0 and "breakdown" in out


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_small_runs_on_the_card(cuda_device, cell):
    """Every cell's path on the card at a small size, traced."""
    r = small_run(cell, device=cuda_device, trace=True)
    out = cli.result(S.load_spec(), cell, r, True, cuda_device)
    assert r.correct, r.checks
    assert out["device"]["busy_s"] > 0
    per_layer = {m["name"] for m in S.cell_metrics(S.load_spec(), cell,
                                                   "per_layer")}
    assert set(out["metrics"]) <= per_layer
