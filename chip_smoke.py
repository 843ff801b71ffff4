#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pysolvers_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It imports nothing of JAX and builds the
port's CUDA kernel from the checkout's sources.  Phases, one line each (any
failure raises and the script exits non-zero):

1. environment: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; no CUDA device is a failure;
2. build of kernel K1 (``csrc/dia_spmv.cu``) with nvcc, and its ptxas report;
3. K1 against its plain twin on the card, f32 and f64: bench.py's two
   operators, the main path's fine operator, a rectangular and a 9-offset
   operator; error bound, then CUDA-event times of both;
4. the main path at real size: PCG + SA-AMG (6 levels) on
   fd_laplacian_2d(1023) in f64 through the factory API, checked on the
   host with scipy;
5. the ``solve()`` front end on fd_laplacian_2d(150), checked the same way.

Then one JSON line on the kernels, and last the device record
``{"ok": true, "device": {...}}``.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# K1 against its twin, as max|y_K1 - y_twin| / max|y_twin|.  Both add the D
# terms in the same order; they differ because nvcc contracts each
# multiply-add into one FMA (one rounding) where the twin rounds the
# product and the sum separately.  That is a few ulps of the partial sums,
# which stay within a small factor of max|y| on these operators.
TOL = {"float32": 1e-6, "float64": 1e-13}
# host-checked ||b - A x|| / ||b|| after a solve at tau = 1e-10
RESID_LIMIT = 1e-9


def phase(n, msg):
    print(f"[phase {n}] {msg}", flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def host_residual(H, x, b):
    import scipy.sparse as sp
    S = sp.csr_matrix((H.data, H.indices, H.indptr), shape=H.shape)
    return float(np.linalg.norm(b - S @ x) / np.linalg.norm(b))


def time_pair(kernel, plain, runs=21, calls=10, warmup=3):
    """Milliseconds per call of each version: the median over ``runs``
    runs, each ``calls`` back-to-back calls between two CUDA events (so
    launch latency overlaps the previous call, as in a solver loop),
    timed in turns (plain, kernel, kernel, plain, ...) after a warm-up."""
    import torch
    for _ in range(warmup):
        kernel()
        plain()
    torch.cuda.synchronize()
    times = {"kernel": [], "plain": []}
    for r in range(runs):
        order = (("plain", plain), ("kernel", kernel))
        for name, fn in (order if r % 2 == 0 else order[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / calls)
    return statistics.median(times["kernel"]), statistics.median(times["plain"])


def k1_operators():
    """(name, HostCSR) pairs of the operators K1 is checked on."""
    from pysolvers_tpu_torch.problems import fd_laplacian_2d
    from pysolvers_tpu_torch.sparse.host import HostCSR
    rng = np.random.default_rng(1)
    ops = []
    for m in (1448, 2047):
        # bench.py:81 — abs row sums ~1, so chained iterates stay bounded
        H = fd_laplacian_2d(m)
        H.data *= 1.0 / (8.0 * (m + 1.0) ** 2)
        ops.append((f"bench fd_laplacian_2d({m})", H))
    ops.append(("main-path fd_laplacian_2d(1023)", fd_laplacian_2d(1023)))

    def banded(shape, offsets):
        n, nc = shape
        rows, cols = [], []
        for off in offsets:
            i = np.arange(max(0, -off), min(n, nc - off))
            rows.append(i)
            cols.append(i + off)
        rows, cols = np.concatenate(rows), np.concatenate(cols)
        return HostCSR.from_coo(rows, cols, rng.standard_normal(len(rows)),
                                shape)

    n = 1_000_003
    ops.append(("rectangular wide (n, n+77)", banded((n, n + 77),
                                                      (-3, 0, 5, 80))))
    ops.append(("rectangular tall (n+100, n)", banded((n + 100, n),
                                                       (-100, -1, 0, 2))))
    m = 1023
    ops.append(("9 offsets, 9-point stencil pattern", banded(
        (m * m, m * m), (-m - 1, -m, -m + 1, -1, 0, 1, m - 1, m, m + 1))))
    return ops


def check_k1(device):
    """Phase 3.  Returns the kernels-record numbers at the main path's
    shape (fd_laplacian_2d(1023), f64)."""
    import torch
    from pysolvers_tpu_torch.ops import spmv
    from pysolvers_tpu_torch.sparse.device import DiaMatrix
    card = card_line()
    rng = np.random.default_rng(0)
    record = None
    for name, H in k1_operators():
        xh = rng.random(H.shape[1])
        for dt in (torch.float32, torch.float64):
            A = DiaMatrix.from_host_csr(H, dtype=dt, device=device)
            x = torch.as_tensor(xh, dtype=dt, device=device)
            y = spmv.dia_spmv(A, x)
            y_ref = spmv.dia_spmv_torch(A, x)
            torch.cuda.synchronize()
            abs_err = float((y - y_ref).abs().max())
            rel = abs_err / float(y_ref.abs().max())
            tol = TOL[str(dt).split(".")[1]]
            ok = bool(torch.isfinite(y).all()) and rel <= tol
            ms, plain_ms = time_pair(lambda: spmv.dia_spmv(A, x),
                                     lambda: spmv.dia_spmv_torch(A, x))
            D, n = len(A.offsets), A.n_rows
            gbs = (D + 2) * n * A.diags.element_size() / (ms * 1e-3) / 1e9
            phase(3, f"K1 {name} {str(dt)[6:]} shape={A.shape} D={D} "
                     f"rel_err={rel:.3e} (tol {tol:g}) K1 {ms:.4f} ms "
                     f"{H.nnz / (ms * 1e-3):.4e} nnz/s {gbs:.1f} GB/s | "
                     f"twin {plain_ms:.4f} ms "
                     f"{H.nnz / (plain_ms * 1e-3):.4e} nnz/s | {card}")
            if not ok:
                raise SystemExit(f"K1 disagrees with its twin on {name} "
                                 f"{dt}: rel {rel:.3e} > {tol:g}")
            if name.startswith("main-path") and dt == torch.float64:
                record = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms)
            del A, x, y, y_ref
    return record


def device_tensors(op):
    """The tensors of a DiaMatrix or EllMatrix."""
    import torch
    return [v for v in vars(op).values() if isinstance(v, torch.Tensor)]


def check_solution(tag, H, b, x_star, st, device):
    import torch
    x = st.soln
    if not isinstance(x, torch.Tensor) or x.device.type != device:
        raise SystemExit(f"{tag}: solution is not a tensor on {device}")
    xh = x.cpu().numpy()
    if xh.shape != (H.shape[0],) or not np.isfinite(xh).all():
        raise SystemExit(f"{tag}: solution has shape {xh.shape} or is "
                         "not finite")
    resid = host_residual(H, xh, b)
    err = float(np.linalg.norm(xh - x_star) / np.linalg.norm(x_star))
    if not st.success or resid > RESID_LIMIT or err > 1e-6:
        raise SystemExit(f"{tag}: success={st.success} resid={resid:.3e} "
                         f"err={err:.3e}")
    return resid, err


def main_path(device, m=1023):
    """Phase 4: run_large.py's SA configuration through the factory API."""
    import torch
    import pysolvers_tpu_torch as pt
    from pysolvers_tpu_torch.ops import spmv
    from pysolvers_tpu_torch.utils.timing import Timer
    H = pt.problems.fd_laplacian_2d(m)
    x_star = np.random.default_rng(2).random(H.shape[0])
    b = H.matvec(x_star)
    solver = pt.PCG(pt.CommonSolverArgs(maxiter=500, tau=1e-10),
                    precond=pt.AMG(num_iters=2, num_levels=6),
                    device=device).make_solver()
    Timer.reset()
    spmv.dia_spmv_launches = 0
    t0 = time.perf_counter()
    st = solver.solve(H, b)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = spmv.dia_spmv_launches
    setup_s = Timer.total("amg.host_hierarchy") + Timer.total(
        "amg.device_lower")
    h = solver._formed_prec.state
    sizes = [int(h.A0_inv.shape[0])] + [L.A_dev.shape[0]
                                        for L in h.levels[1:]]
    fine_op = solver._split_cache[1][1]
    tensors = [h.A0_inv, *device_tensors(fine_op)]
    for L in h.levels[1:]:
        tensors += [L.dinv, *device_tensors(L.A_dev), *device_tensors(L.P_dev),
                    *device_tensors(L.R_dev)]
    if any(t.device.type != device for t in tensors):
        raise SystemExit("an operator of the solve is not on the device")
    formats = [type(L.A_dev).__name__ for L in h.levels[1:]]
    resid, err = check_solution("main path", H, b, x_star, st, device)
    if launches <= 0:
        raise SystemExit("the main path launched K1 no time")
    # the same solve again with the matrix and preconditioner frozen:
    # the solve alone, without setup
    solver.freeze_matrix()
    solver.freeze_prec()
    t0 = time.perf_counter()
    st2 = solver.solve(H, b)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    phase(4, f"PCG+AMG(num_iters=2, num_levels=6) fd_laplacian_2d({m}) f64 "
             f"n={H.shape[0]}: first call {first_s:.3f} s (AMG setup "
             f"{setup_s:.3f} s), frozen re-solve {solve_s:.3f} s; "
             f"iters={st.iters} reason={st.reason.name} levels={sizes} "
             f"level formats={formats} smoother={h.smoother} "
             f"K1 launches={launches} host rel resid={resid:.3e} "
             f"err vs manufactured={err:.3e} re-solve iters={st2.iters} | "
             f"{card_line()}")
    return launches


def front_end(device, m=150):
    """Phase 5: solve() with every argument but tau and device at its
    default."""
    import torch
    import pysolvers_tpu_torch as pt
    from pysolvers_tpu_torch.ops import spmv
    H = pt.problems.fd_laplacian_2d(m)
    x_star = np.random.default_rng(3).random(H.shape[0])
    b = H.matvec(x_star)
    spmv.dia_spmv_launches = 0
    t0 = time.perf_counter()
    st = pt.solve(H, b, tau=1e-10, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = spmv.dia_spmv_launches
    resid, err = check_solution("solve()", H, b, x_star, st, device)
    if launches <= 0:
        raise SystemExit("solve() launched K1 no time")
    phase(5, f"solve() fd_laplacian_2d({m}) n={H.shape[0]}: {wall:.3f} s "
             f"iters={st.iters} reason={st.reason.name} K1 launches="
             f"{launches} host rel resid={resid:.3e} err={err:.3e}")


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script runs only on the GPU")
    sys.path.insert(0, ROOT)
    import pysolvers_tpu_torch
    from pysolvers_tpu_torch.ops import _cuda_build
    if not os.path.abspath(pysolvers_tpu_torch.__file__).startswith(
            ROOT + os.sep):
        raise SystemExit("pysolvers_tpu_torch is not this checkout's")
    card = card_line()
    print(card, flush=True)
    phase(1, f"torch {torch.__version__} CUDA {torch.version.cuda} "
             f"device {torch.cuda.get_device_name(0)} "
             f"count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    so = _cuda_build.build("dia_spmv")
    build_s = time.perf_counter() - t0
    with open(os.path.join(_cuda_build.BUILD_DIR, "libdia_spmv.log")) as f:
        ptxas = " / ".join(ln.strip() for ln in f if "ptxas info" in ln
                           and ("Used" in ln or "spill" in ln))
    phase(2, f"built {os.path.relpath(so, ROOT)} in {build_s:.2f} s; {ptxas}")

    rec = check_k1("cuda")
    launches = main_path("cuda")
    front_end("cuda")

    print(json.dumps({"kernels": [dict(
        name="dia_spmv", route="cuda",
        source="pysolvers_tpu_torch/csrc/dia_spmv.cu",
        replaces="pysolvers_tpu/ops/spmv.py:197",
        launches=launches, **rec)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
