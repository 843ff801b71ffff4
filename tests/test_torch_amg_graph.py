"""The AMG preconditioner's apply served by one CUDA graph
(``ops/cuda_graph.py::GraphedApply``, ``linear/amg.py::_replays_as_graph``).

On the CPU (tier-1): the apply stays the eager V-cycles, bit for bit; every
apply is counted and none is a graph launch; the rule that engages the
graph leaves out the CPU, a mesh and the "gs"/"sgs" smoothers; the launch
counters' bookkeeping; the benchmark's reader of the replay share.

On the card (``cuda``, skipped without one; this file imports neither jax
nor pysolvers_tpu, so it runs on a GPU machine without JAX)::

    python -m pytest --noconftest tests/test_torch_amg_graph.py -q

a replay against the eager V-cycles on the same input (bit-equal on a DIA +
ELL hierarchy, within K2's f64 tolerance, 1e-12, on a BWS one, and on an
f32 one), whole solves against the eager path (iterations, answers, every
launch counter), no aliasing of the results handed out, no growth of the
allocated memory over re-formed preconditioners, and no synchronising
call in a replay.
"""
import dataclasses
import gc
import types

import numpy as np
import pytest
import torch

import pysolvers_tpu_torch as pt
import pysolvers_tpu_torch.linear.amg as tamg
from pysolvers_tpu_torch.ops import _cuda_build, cuda_graph, spmv
from pysolvers_tpu_torch.sparse.bws import BwsCsrMatrix, BwsMatrix
from pysolvers_tpu_torch.utils.timing import Timer

NUM_ITERS = 2
GRAPH_COUNTERS = ("amg.graph_captures", "amg.graph_replays")


@pytest.fixture
def clean_timers():
    Timer.reset()
    yield
    Timer.reset()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


def _cycles(h, v, num_iters=NUM_ITERS):
    """The eager apply: ``num_iters`` V-cycles from zero."""
    x = torch.zeros_like(v)
    for _ in range(num_iters):
        x = tamg.v_cycle(h, v, x)
    return x


def _rel(y, y_ref):
    return float((y - y_ref).abs().max() / y_ref.abs().max())


# ---------------------------------------------------------------------------
# CPU: the eager apply, the counters, the rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoother", ["gs", "sgs", "jacobi", "chebyshev"])
def test_cpu_apply_is_the_eager_cycles(clean_timers, smoother):
    H = pt.problems.fd_laplacian_2d(31)
    prec = pt.AMG(num_iters=NUM_ITERS, num_levels=3, smoother=smoother,
                  galerkin="host").form(H, device="cpu")
    v = torch.as_tensor(np.random.default_rng(0).random(H.shape[0]))
    outs = [prec.apply_any(v) for _ in range(3)]
    ref = _cycles(prec.state, v)
    assert all(torch.equal(o, ref) for o in outs)
    assert Timer.calls("amg.applies") == 3
    assert all(Timer.calls(c) == 0 for c in GRAPH_COUNTERS)


def test_applies_count_every_apply_of_a_solve(clean_timers):
    H = pt.problems.fd_laplacian_2d(31)
    b = H.matvec(np.random.default_rng(1).random(H.shape[0]))
    st = pt.PCG(pt.CommonSolverArgs(maxiter=100, tau=1e-10),
                precond=pt.AMG(num_iters=NUM_ITERS, num_levels=3),
                device="cpu").make_solver().solve(H, b)
    assert st.success
    # M(r0), then one per iteration
    assert Timer.calls("amg.applies") == st.iters + 1
    assert all(Timer.calls(c) == 0 for c in GRAPH_COUNTERS)


@pytest.mark.parametrize("device, smoother, mesh, engaged", [
    ("cuda:0", "jacobi", None, True),
    ("cuda:0", "chebyshev", None, True),
    ("cuda:0", "gs", None, False),
    ("cuda:0", "sgs", None, False),
    ("cuda:0", "jacobi", object(), False),
    ("cpu", "jacobi", None, False),
])
def test_graph_engages_on_one_card_with_a_sync_free_smoother(
        device, smoother, mesh, engaged):
    h = types.SimpleNamespace(device=torch.device(device), smoother=smoother)
    assert tamg._replays_as_graph(h, mesh) is engaged


def test_launch_counts_see_every_wrapper_counter():
    counters, _ = cuda_graph.launch_counts()
    names = {name for _, name in counters}
    assert {"dia_spmv_launches", "dia_spmv_jvp_launches",
            "bdia_spmv_launches", "bdia_spmm_launches", "bws_spmv_launches",
            "bws_spmv_classes_launches", "grid_dia_spmv_launches",
            "lane_gather_probe_launches",
            "block_trisolve_launches"} <= names


def test_a_capture_is_counted_again_on_each_replay(monkeypatch):
    """What the wrappers counted while a graph was captured is what each
    replay adds: the launch counters read as if every call were eager."""
    monkeypatch.setattr(spmv, "dia_spmv_launches", 7)
    monkeypatch.setattr(_cuda_build, "launches_by_dtype",
                        _cuda_build.launches_by_dtype.copy())
    before = cuda_graph.launch_counts()
    for _ in range(3):                       # a capture's launches
        spmv.dia_spmv_launches += 1
        _cuda_build.count_launch("K1", torch.float64)
    _cuda_build.count_launch("K2", torch.float32)
    delta = cuda_graph.launches_since(before)
    assert delta[0] == {(spmv, "dia_spmv_launches"): 3}
    for _ in range(2):                       # two replays
        cuda_graph.add_launches(delta)
    assert spmv.dia_spmv_launches == 7 + 3 * 3
    assert _cuda_build.launches_by_dtype["K1", "float64"] \
        - before[1]["K1", "float64"] == 9
    assert _cuda_build.launches_by_dtype["K2", "float32"] \
        - before[1]["K2", "float32"] == 3


def test_reader_graph_replay_share(clean_timers):
    from solverbench.lib import spec as S
    read = S.metric_reader("precond.graph_replay_share")
    assert read(None) is None                # a program without the counter
    Timer.count("amg.applies", 40)
    assert read(None) == 0.0
    Timer.count("amg.graph_replays", 30)
    assert read(None) == pytest.approx(75.0)


# ---------------------------------------------------------------------------
# CUDA: replays against the eager cycles
# ---------------------------------------------------------------------------

def _eager_only(monkeypatch):
    """Every preconditioner formed from here on applies eagerly."""
    monkeypatch.setattr(tamg, "GraphedApply", lambda fn, name, device: fn)


def _fem(m=129):
    A = pt.problems.fem_poisson_2d_unstructured(m, seed=3)
    return A.permute_symmetric(BwsMatrix._rcm_perm(A))


def _formed(case, cuda):
    """(the formed preconditioner, the input dtype, the tolerance of a
    replay against the eager cycles: 0 for bit-equal)."""
    if case == "dia_ell":                    # K1 fine, ELL coarse levels
        H = pt.problems.fd_laplacian_2d(255)
        prec = pt.AMG(num_iters=NUM_ITERS, num_levels=6,
                      galerkin="host").form(H, device=cuda)
        kinds = {type(lvl.A_dev).__name__ for lvl in prec.state.levels}
        assert {"DiaMatrix", "EllMatrix"} <= kinds
        return prec, torch.float64, 0.0
    if case == "bws":                        # K2 on every BWS-lane level
        prec = pt.AMG(num_iters=NUM_ITERS, num_levels=4, galerkin="host",
                      matrix_format="bws").form(_fem(), device=cuda)
        # on the card the levels are lowered straight to K2's layout
        assert isinstance(prec.state.levels[-1].A_dev, BwsCsrMatrix)
        return prec, torch.float64, 1e-12
    H = pt.problems.fd_laplacian_2d(255)     # f32 hierarchy
    H32 = dataclasses.replace(H, data=H.data.astype(np.float32))
    prec = pt.AMG(num_iters=NUM_ITERS, num_levels=6,
                  galerkin="host").form(H32, device=cuda)
    assert prec.state.A0_inv.dtype == torch.float32
    return prec, torch.float32, 1e-12


@pytest.mark.parametrize("case", ["dia_ell", "bws", "f32"])
def test_replay_equals_the_eager_cycles(cuda, case, clean_timers):
    prec, dtype, tol = _formed(case, cuda)
    n = prec.state.levels[-1].A_dev.shape[0]
    gen = torch.Generator().manual_seed(5)
    vs = [torch.rand(n, generator=gen, dtype=torch.float64).to(dtype)
          .to(cuda) for _ in range(4)]
    outs = [prec.apply_any(v) for v in vs]
    assert Timer.calls("amg.applies") == 4
    assert Timer.calls("amg.graph_captures") == 1
    assert Timer.calls("amg.graph_replays") == 3
    # results handed out stay theirs: each replay overwrites the graph's
    # static output, so an alias would read the last input's answer
    for v, out in zip(vs, outs):
        ref = _cycles(prec.state, v)
        if tol == 0.0:
            assert torch.equal(out, ref)
        else:
            assert _rel(out, ref) <= tol


def _reset_launches():
    for module, name in cuda_graph.launch_counts()[0]:
        setattr(module, name, 0)
    _cuda_build.launches_by_dtype.clear()


def _pcg_solves(case, cuda):
    """Two PCG + AMG solves, the preconditioner frozen after the first:
    (statuses, launch counts)."""
    rng = np.random.default_rng(7)
    if case == "bws":
        H = _fem()
        A = (H, BwsMatrix.from_host_csr(H, dtype=np.float64, use_rcm=False,
                                        device=cuda))
        amg = pt.AMG(num_iters=NUM_ITERS, num_levels=4, galerkin="host",
                     matrix_format="bws")
    else:
        H = A = pt.problems.fd_laplacian_2d(255)
        amg = pt.AMG(num_iters=NUM_ITERS, num_levels=6, galerkin="host")
    s = pt.PCG(pt.CommonSolverArgs(maxiter=500, tau=1e-10), precond=amg,
               precision="mixed" if case == "mixed" else "native",
               device=cuda).make_solver()
    _reset_launches()
    sts = [s.solve(A, H.matvec(rng.random(H.shape[0])))]
    s.freeze_matrix()
    s.freeze_prec()
    sts.append(s.solve(A, H.matvec(rng.random(H.shape[0]))))
    torch.cuda.synchronize()
    return sts, cuda_graph.launch_counts()


@pytest.mark.parametrize("case", ["dia_ell", "bws", "mixed"])
def test_pcg_matches_the_eager_path(cuda, case, monkeypatch, clean_timers):
    """Iterations, answers and every launch counter of whole solves equal
    the eager path's."""
    graphed, counts = _pcg_solves(case, cuda)
    # each formed preconditioner's first apply is its eager warm-up
    captures = Timer.calls("amg.graph_captures")
    assert captures >= 1 and Timer.calls("amg.graph_replays") == \
        Timer.calls("amg.applies") - captures
    _eager_only(monkeypatch)
    Timer.reset()
    eager, eager_counts = _pcg_solves(case, cuda)
    assert all(Timer.calls(c) == 0 for c in GRAPH_COUNTERS)
    assert counts == eager_counts
    for st, ref in zip(graphed, eager):
        assert st.success and st.iters == ref.iters
        if case == "dia_ell":
            assert torch.equal(st.soln, ref.soln)
        else:
            assert _rel(st.soln, ref.soln) <= 1e-12


def test_fgmres_and_multi_rhs_get_the_eager_answers(cuda, monkeypatch):
    """FGMRES keeps every z_j and ``solve(A, B)`` stacks the columns'
    results: both read what the eager applies give."""
    H = pt.problems.fd_laplacian_2d(255)
    rng = np.random.default_rng(9)
    b = H.matvec(rng.random(H.shape[0]))
    B = np.stack([H.matvec(rng.random(H.shape[0])) for _ in range(3)], 1)

    def run():
        fg = pt.GMRES(pt.CommonSolverArgs(maxiter=100, tau=1e-10),
                      precond=pt.AMG(num_iters=NUM_ITERS, num_levels=6,
                                     galerkin="host"),
                      flexible=True, device=cuda).make_solver().solve(H, b)
        multi = pt.solve(H, B, tau=1e-10, precond="amg", device=cuda)
        return fg, multi

    graphed = run()
    _eager_only(monkeypatch)
    eager = run()
    for st, ref in zip(graphed, eager):
        assert st.success and np.array_equal(np.asarray(st.iters),
                                             np.asarray(ref.iters))
        assert _rel(st.soln, ref.soln) <= 1e-12


def test_reformed_preconditioners_free_their_graphs(cuda):
    """A formed preconditioner owns its graphs and their memory pools: 20
    formed, captured and dropped leave the allocated memory where one
    did."""
    H = pt.problems.fd_laplacian_2d(127)
    typ = pt.AMG(num_iters=NUM_ITERS, num_levels=4, galerkin="host")
    v = torch.rand(H.shape[0], dtype=torch.float64, device=cuda)

    def once():
        prec = typ.form(H, device=cuda)
        for _ in range(3):
            prec.apply_any(v)

    once()
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    for _ in range(20):
        once()
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() <= base


def test_a_replay_never_syncs(cuda, clean_timers):
    prec, _, _ = _formed("dia_ell", cuda)
    v = torch.rand(prec.state.levels[-1].A_dev.shape[0], dtype=torch.float64,
                   device=cuda)
    prec.apply_any(v)
    prec.apply_any(v)                        # the capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [prec.apply_any(v) for _ in range(2)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert Timer.calls("amg.graph_replays") == 3
    assert torch.equal(outs[0], outs[1])


def test_gs_on_the_card_stays_eager(cuda, clean_timers):
    H = pt.problems.fd_laplacian_2d(63)
    prec = pt.AMG(num_iters=NUM_ITERS, num_levels=3, smoother="gs",
                  galerkin="host").form(H, device=cuda)
    v = torch.rand(H.shape[0], dtype=torch.float64, device=cuda)
    outs = [prec.apply_any(v) for _ in range(3)]
    assert all(torch.equal(o, _cycles(prec.state, v)) for o in outs)
    assert Timer.calls("amg.applies") == 3
    assert all(Timer.calls(c) == 0 for c in GRAPH_COUNTERS)
