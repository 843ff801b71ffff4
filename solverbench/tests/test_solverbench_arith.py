"""The window, percentile, idle-share, roofline and reference arithmetic,
on synthetic inputs."""
import numpy as np
import pytest

from solverbench.lib import roofline, spec as S, trace
from solverbench.lib.loop import Run
from solverbench.reference import residual


def synthetic_run(walls, iters, traced=None, timers=None, summary=None,
                  cfg=None):
    traced = traced or [False] * len(walls)
    return Run(cfg=cfg or {}, mix={}, A=None, setup_s=12.5,
               window_s=float(sum(walls)) + 0.5,
               solves=[dict(wall_s=w, iters=k, success=True, traced=t)
                       for w, k, t in zip(walls, iters, traced)],
               timers=timers or {}, trace=summary, kernels=S.kernels(),
               checks={}, memory_peak_bytes=0, setup_parts={})


def read(name, run):
    return S.metric_reader(name)(run)


def test_window_rates_and_the_tail():
    walls = [0.08] * 90 + [0.1] * 10
    run = synthetic_run(walls, [11] * 100)
    assert read("resolve_ms", run) == pytest.approx(1e3 * (8.2 + 0.5) / 100)
    assert read("entry.resolve_mean_ms", run) == read("resolve_ms", run)
    assert read("fresh_s", run) == pytest.approx((8.2 + 0.5) / 100)
    # numpy's linear interpolation: position 0.95 * 99 = 94.05 -> 0.1
    assert read("resolve_ms_p95", run) == pytest.approx(100.0)
    assert read("resolve_ms_p95", synthetic_run(
        list(np.linspace(0.01, 0.02, 21)), [1] * 21)) == pytest.approx(19.5)
    assert read("setup_s", run) == 12.5
    assert read("krylov.iters", synthetic_run([1, 1], [11, 12])) == 11.5
    assert read("resolve_ms", synthetic_run([], [])) is None


def test_setup_timers_per_solve():
    run = synthetic_run([3.0, 3.0], [11, 11], timers={
        "amg.host_hierarchy": 4.0, "amg.device_aggregate": 1.0,
        "amg.device_lower": 0.6})
    assert read("amg_setup.host_s", run) == pytest.approx(2.5)
    assert read("amg_setup.lower_s", run) == pytest.approx(0.3)
    assert read("amg_setup.host_s", synthetic_run([1], [1])) is None


def test_union_and_gaps():
    s = np.array([0.0, 1.0, 1.5, 5.0])
    e = np.array([2.0, 1.2, 3.0, 6.0])
    assert trace.union_length(s, e) == pytest.approx(4.0)
    assert trace.idle_gaps(0.0, 8.0, s, e) == [(3.0, 5.0), (6.0, 8.0)]
    assert trace.idle_gaps(-1.0, 1.0, s, e) == [(-1.0, 0.0)]
    assert trace.union_length(np.array([]), np.array([])) == 0.0


def test_gaps_named_by_the_innermost_host_op():
    gaps = [(1.0, 2.0), (4.0, 4.5), (9.0, 9.5), (2.6, 2.8)]
    names = trace.name_gaps(
        gaps, [0.0, 1.2, 3.5, 2.5], [8.0, 1.8, 5.0, 3.0],
        ["solve", "aten::item", "cudaLaunchKernel", "aten::mul"])
    assert dict(names) == pytest.approx({
        "aten::item": 1.0, "cudaLaunchKernel": 0.5, "(no host op)": 0.5,
        "aten::mul": 0.2})


def summary(window, busy, kernels):
    return trace.TraceSummary(
        window_s=window, busy_s=busy, kernel_names=[k for k, _ in kernels],
        kernel_s=np.array([d for _, d in kernels]), device_ops=[],
        idle_gaps=[])


def test_idle_share_and_launches():
    t = summary(0.5, 0.2, [("a", 1e-5)] * 300)
    run = synthetic_run([0.1, 0.1, 0.1], [10, 10, 10],
                        traced=[True, True, False], summary=t)
    assert read("device.idle.resolve", run) == pytest.approx(60.0)
    assert read("device.idle.fresh", run) == pytest.approx(60.0)
    assert read("krylov.launches_per_iter", run) == pytest.approx(15.0)
    untraced = synthetic_run([0.1], [10])
    for name in ("device.idle.resolve", "krylov.launches_per_iter",
                 "kernels.fine_spmv_roofline"):
        assert read(name, untraced) is None


def test_roofline_bound_times_of_both_fine_operators():
    # DIA, 5 diagonals, n = 1023^2: 0.0175 ms a product at 3.35 TB/s
    n = 1023 * 1023
    assert 1e3 * roofline.spmv_bound_s("dia", n, 5 * n, 5) == pytest.approx(
        0.0175, abs=5e-5)
    # the CSR minimum of the FEM operator: 0.0325 ms
    assert 1e3 * roofline.spmv_bound_s(
        "csr", 1048576, 7331842, 0) == pytest.approx(0.0325, abs=5e-5)
    with pytest.raises(ValueError):
        roofline.spmv_bytes("ell", 1, 1, 0)


def test_fine_products_as_the_v_cycle_makes_them():
    p = {"num_iters": 2, "nu_pre": 2, "nu_post": 2}
    # chip_smoke's phase 4: 132 K1 launches over 11 iterations
    assert roofline.fine_products(p, 11) == 132


def test_fine_roofline_takes_the_longest_launches():
    A = S.build_operator({"kind": "fd5_laplacian_2d", "m": 20})
    p = {"num_iters": 1, "nu_pre": 1, "nu_post": 0}
    cfg = {"fine_format": "dia", "dtype": "float64",
           "solver": {"precond": p}}
    bound = roofline.spmv_bound_s("dia", A.n, A.nnz, 5)
    # 2 iterations -> 3 * (1 + 2) = 9 fine products of 2 x bound each,
    # and coarse launches of the same kernel, shorter
    kernels = ([("void dia_spmv_kernel<double>(...)", 2 * bound)] * 9
               + [("void dia_spmv_kernel<double>(...)", 0.1 * bound)] * 5
               + [("elementwise", 50 * bound)])
    run = synthetic_run([0.1], [2], traced=[True], cfg=cfg,
                        summary=summary(1.0, 0.5, kernels))
    run.A = A
    assert read("kernels.fine_spmv_roofline", run) == pytest.approx(50.0)
    # fewer launches than products: nothing to read
    run.trace = summary(1.0, 0.5, kernels[:8])
    assert read("kernels.fine_spmv_roofline", run) is None


def test_reference_judges_residual_and_error():
    A = S.build_operator({"kind": "fd5_laplacian_2d", "m": 10})
    rng = np.random.default_rng(0)
    x_star = rng.random(A.n)
    b = residual.csr_matvec(A.indptr, A.indices, A.data, x_star)
    ok = residual.judge(A.indptr, A.indices, A.data, b, x_star, x_star)
    assert ok["resid"] < 1e-15 and ok["err"] == 0.0
    x = x_star.copy()
    x[3] += 1e-3
    bad = residual.judge(A.indptr, A.indices, A.data, b, x, x_star)
    assert bad["resid"] > 1e-6 and bad["err"] > 1e-5
    nan = residual.judge(A.indptr, A.indices, A.data, b, x * np.nan, x_star)
    assert nan["resid"] == residual.FAIL


def test_reference_takes_the_worst_column_of_a_block():
    A = S.build_operator({"kind": "fd5_laplacian_2d", "m": 7})
    X = np.random.default_rng(1).random((A.n, 4))
    B = residual.csr_matvec(A.indptr, A.indices, A.data, X)
    for j in range(4):
        np.testing.assert_allclose(B[:, j], residual.csr_matvec(
            A.indptr, A.indices, A.data, X[:, j]), rtol=1e-15)
    Y = X.copy()
    Y[5, 2] += 1e-3
    one = residual.judge(A.indptr, A.indices, A.data, B[:, 2], Y[:, 2],
                         X[:, 2])
    block = residual.judge(A.indptr, A.indices, A.data, B, Y, X)
    assert block == pytest.approx(one, rel=1e-12)
    assert block["resid"] > 1e-6
