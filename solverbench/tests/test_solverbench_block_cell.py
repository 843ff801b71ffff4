"""The files of the cell ``vec_laplacian_b5_2M.resolve``: the node-major
block operator against the program's ``fd_vector_laplacian_2d``, the
block-DIA operand against the program's own pack, the block roofline's
arithmetic, and whole runs at m = 24 on the CPU (sound: correct; x0 handed
back, one entry altered or float32: not correct; traced: the program's
span read) and, marked ``cuda``, on the card.  (``helpers.small_run``
has no cut for this configuration: its runs are here.)"""
import importlib
import time

import numpy as np
import pytest
import torch

from solverbench import run as cli
from solverbench.lib import loop, roofline_bdia, spec as S

CELL = "vec_laplacian_b5_2M.resolve"
CONFIG = "vec_laplacian_b5_2M"
SMALL_M = 24
BIG_SEED = 2**31 + 2323


def small_run(device="cpu", seed=BIG_SEED, trace=False, **kw):
    """One run of the cell with the grid cut to m = 24 (n = 2,880), the
    configuration's solver otherwise; every solve checked."""
    spec = S.load_spec()
    w = S.workload(spec, CELL)
    cfg = S.config(spec, w["config"])
    cfg["operator"]["m"] = SMALL_M
    kw.setdefault("check_every", 1)
    kw.setdefault("max_solves", 3)
    return loop.run_cell(cfg, S.mix(w["traffic"]), seed, 30.0, trace,
                         device, time.perf_counter(), **kw)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _op(m, b=5, coupling=0.2):
    return S.build_operator({"kind": "fd_vector_laplacian_2d", "m": m,
                             "b": b, "coupling": coupling})


@pytest.mark.parametrize("b,coupling", [(5, 0.2), (2, 0.3), (3, -0.1)])
@pytest.mark.parametrize("m", [1, 2, 7, SMALL_M])
def test_the_operator_is_the_programs_entry_for_entry(m, b, coupling):
    from pysolvers_tpu_torch.problems import fd_vector_laplacian_2d
    A = _op(m, b, coupling)
    H = fd_vector_laplacian_2d(m, b=b, coupling=coupling)
    for a, h in ((A.indptr, H.indptr), (A.indices, H.indices),
                 (A.data, H.data)):
        assert a.dtype == h.dtype
        np.testing.assert_array_equal(a, h)


def test_the_configuration_states_its_operator():
    cfg = S.config(S.load_spec(), CONFIG)
    op = cfg["operator"]
    m, b = op["m"], op["b"]
    assert cfg["n"] == m * m * b
    assert cfg["nnz"] == (5 * m * m - 4 * m) * b * b
    assert cfg["block_offsets"] == 5         # the stencil's block offsets
    assert S.plugin("operands", cfg["solver"]["operand"]).B == b


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_the_operand_is_the_programs_pack(dtype):
    from pysolvers_tpu_torch.sparse.bdia import BdiaMatrix
    from pysolvers_tpu_torch.sparse.host import HostCSR
    A = _op(SMALL_M)
    D = S.plugin("operands", "bdia_b5_on_card").make(A, dtype, "cpu")
    ref = BdiaMatrix.from_host_csr(
        HostCSR(A.indptr, A.indices, A.data, (A.n, A.n)), 5, dtype=dtype,
        device="cpu")
    assert D.offsets == ref.offsets == (-SMALL_M, -1, 0, 1, SMALL_M)
    assert D.shape == ref.shape and D.b == 5
    assert D.planes.dtype == getattr(torch, dtype)
    assert torch.equal(D.planes, ref.planes)
    assert torch.equal(D.offsets_dev, ref.offsets_dev)


def test_the_block_roofline_arithmetic():
    """(D·b² + 2b)·nb·w bytes: 453.5 MB and 0.1354 ms at 3.35 TB/s for the
    configuration's operator in float64, bound by the bytes."""
    nb = 648 * 648
    assert roofline_bdia.bdia_spmv_bytes(nb, 5, 5) == 453_496_320
    assert roofline_bdia.bdia_spmv_bytes(nb, 5, 5, word=4) == 226_748_160
    assert roofline_bdia.bdia_spmv_bound_s(nb, 5, 5) == pytest.approx(
        1.3537e-4, rel=1e-4)
    assert roofline_bdia.pcg_products(17) == 18


def test_a_small_run_is_correct_and_counts_its_products():
    """Correct, every end-to-end metric read; the program's "bdia.products"
    over the window is the roofline reader's count of its solves."""
    from pysolvers_tpu_torch.utils.timing import Timer
    r = small_run()
    assert r.correct, r.checks
    assert len(r.solves) == 3 and r.failed == 0
    assert Timer.calls("bdia.products") == sum(
        roofline_bdia.pcg_products(s["iters"]) for s in r.solves)
    assert "bdia.bmg_setup" not in r.timers      # formed in set-up only
    out = cli.result(S.load_spec(), CELL, r, False, "cpu")
    e2e = {m["name"] for m in S.cell_metrics(S.load_spec(), CELL,
                                             "end_to_end")}
    assert e2e == {"resolve_ms", "resolve_ms_p95", "setup_s"}
    assert set(out["metrics"]) == e2e


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    """x0 handed back, or one entry of the answer altered."""
    tsolve = importlib.import_module("pysolvers_tpu_torch.solve")
    solve = tsolve._solve_bdia

    def broken(*a, **k):
        st = solve(*a, **k)
        if fault == "unchanged":
            st.soln = torch.zeros_like(st.soln)
        else:
            st.soln = st.soln.clone()
            st.soln[st.soln.numel() // 2] += 1e-3
        return st
    monkeypatch.setattr(tsolve, "_solve_bdia", broken)
    r = small_run(max_solves=2)
    assert not r.correct
    assert r.checks["resid_max"]["value"] > r.checks["resid_max"]["limit"]


def test_the_control_is_not_correct():
    """The same route in float32 fails the residual's limit."""
    r = small_run(dtype="float32", max_solves=2)
    assert not r.correct
    assert r.checks["resid_max"]["value"] > r.checks["resid_max"]["limit"]


def test_a_traced_small_run_reads_the_programs_span():
    """On the CPU the trace holds no kernel: only the span reader reads."""
    r = small_run(trace=True, max_solves=2)
    out = cli.result(S.load_spec(), CELL, r, True, "cpu")
    assert r.correct
    assert set(out["metrics"]) == {"bmg.apply_ms"}
    assert out["metrics"]["bmg.apply_ms"]["value"] > 0


def test_the_cell_finds_its_files_and_no_dia_reader():
    """Every file the cell names, K4 among the roofline's kernels, and no
    reader of the "dia" format among the cell's metrics: K1's name is a
    substring of K4's."""
    spec = S.load_spec()
    cfg = S.config(spec, CONFIG)
    assert callable(S.plugin("operators", cfg["operator"]["kind"]).build)
    assert callable(S.plugin("solvers", cfg["solver"]["route"]).Route)
    assert callable(S.plugin("operands", cfg["solver"]["operand"]).make)
    assert callable(S.plugin("reference", cfg["check"]).judge)
    bdia = [k["contains"] for k in S.kernels() if k["format"] == "bdia"]
    assert bdia == ["bdia_spmv_kernel"]
    names = {m["name"] for m in S.cell_metrics(spec, CELL, "per_layer")}
    assert names == {"bmg.apply_ms", "bmg.device_ms_per_iter",
                     "kernels.block_spmv_roofline", "device.idle.block"}
    assert "kernels.fine_spmv_roofline" not in names
    assert "kernels.gmg_fine_roofline" not in names


@pytest.mark.cuda
def test_a_small_run_on_the_card(cuda_device):
    r = small_run(device=cuda_device, trace=True)
    out = cli.result(S.load_spec(), CELL, r, True, cuda_device)
    assert r.correct, r.checks
    assert out["device"]["busy_s"] > 0
    assert {"bmg.apply_ms", "bmg.device_ms_per_iter",
            "kernels.block_spmv_roofline",
            "device.idle.block"} == set(out["metrics"])
    assert 0 < out["metrics"]["kernels.block_spmv_roofline"]["value"] <= 105
