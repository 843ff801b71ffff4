#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pysolvers_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --bws-sweep [THREADS,UNROLL,EVICT_FIRST ...]

Run from the root of a checkout.  It imports nothing of JAX and builds the
port's CUDA kernels from the checkout's sources.  Phases, one line each or
more (any failure raises and the script exits non-zero):

1. environment: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; no CUDA device is a failure;
2. build of kernels K1 (``csrc/dia_spmv.cu``), K2/K3 (``csrc/bws_spmv.cu``),
   K7 (``csrc/lane_gather_probe.cu``), K4/K5 (``csrc/bdia_spmv.cu``), K6
   (``csrc/grid_dia_spmv.cu``) and K8 (``csrc/block_trisolve.cu``), one
   nvcc each, all at once, and their ptxas reports (registers, spills; a
   spill in K4/K5 fails);
3. K1 against its plain twin on the card, f32 and f64: bench.py's two
   operators, the main path's fine operator, a rectangular and a 9-offset
   operator; error bound, then CUDA-event times of both and of the
   library call computing the same product (here a torch CSR product);
4. the banded main path at real size: PCG + SA-AMG (6 levels) on
   fd_laplacian_2d(1023) in f64 through the factory API, checked on the
   host with scipy;
5. the ``solve()`` front end on fd_laplacian_2d(150) with no ``device``
   argument: it must solve on the card (the port's default), checked the
   same way;
6. K7, the lane-index probe of ``benchmarks/probe_idx16.py``, bit-exact
   against numpy, timed beside its twin and ``torch.gather``;
7. the unstructured main path: PCG + SA-AMG (4 levels, every level
   operator and transfer packed as BWS, each with its device CSR) on the
   RCM-reordered fem_poisson_2d_unstructured(1025, seed=3) in f64, n =
   1,048,576, with the caller's BWS pack as the fine operator; checked on
   the host; one K2 launch per BWS product and no K3 launch; the layout's
   device bytes; the median of five frozen re-solves;
8. K2 (``bws_spmv``) against its twin on every operator of that
   hierarchy, f32 and f64, and K3 (``bws_spmv_by_class``) on the fine
   operator, plus both on a graph_laplacian_rgg operator at n = 1e6;
   CUDA-event times (and of a torch CSR product on the fine operator);
9. K4 (``csrc/bdia_spmv.cu``) and K5 (the same source, k = 1, 8, 16 and 20
   right-hand sides) against their twins, f32 and f64: the block lane's
   full-width operator, fd_vector_laplacian_2d(648, b=5, coupling=0.2)
   (``benchmarks/bdia_solve_tpu.py``'s configuration, n = 2,099,520), its
   D = 1 block-Jacobi inverse and a random nonsymmetric b = 3 operator
   with odd nb; CUDA-event times of both (and of a torch BSR product in
   node-major order on the first two, at k = 1 and 8);
10. the block lane single-RHS at full width: ``solve(BdiaMatrix, b)`` in
   f64 with precond "auto" (block-Jacobi) and "bmg", checked on the host;
11. the block lane multi-RHS: ``solve(BdiaMatrix, B)`` with k = 8
   (block-Jacobi), checked per column on the host; and the HostCSR
   auto-route on fd_vector_laplacian_2d(150, b=5, coupling=0.2);
12. K6 (``csrc/grid_dia_spmv.cu``) against its twin, f32 and f64, on the
   geometric-multigrid path's operators: the full-width fine operator of
   ``benchmarks/hbm_solve.py`` (the 5-point Laplacian on a 10239 x 10239
   grid, n = 104,837,121, assembled on the host straight into DIA storage)
   in grid form, with K1 timed on the same operator in flat DIA form; the
   probed 9-point m = 5119 level; a random D = 85 table on a 1001 x 777
   grid, nonzero at the edges; CUDA-event times of both (and of a torch
   CSR product of the first two, built on the card);
13. the geometric-multigrid path at full width (``hbm_solve.py``'s
   ``run_solve`` at its default m = 10239, native f64): PCG preconditioned
   by two V-cycles of the 10-level device-probed grid hierarchy
   (``build_grid_hierarchy_device``, Jacobi, K6 on m = 10239 and 5119, K1
   below) to tau = 1e-10, checked on the host by the matrix-free stencil;
   a repeat solve, and one more under ``torch.profiler``;
14. the object-oriented GMG entry points at ``run_large.py``'s m = 1023
   (6 levels, f64, tau = 1e-10, no K6 at this width): PCG with
   ``GMGPreconditionerType`` (galerkin "host" and "device") and
   ``GMGVCycle(matrix_format="grid")``, checked on the host with scipy;
16. GMRES + ILUT, ``solve()``'s nonsymmetric default: ``pt.solve(H, b,
   tau=1e-10)`` with no method, preconditioner or device on
   fd_convection_diffusion_2d(255) (n = 65,025), full GMRES with the
   ILUT factors applied by block-banded solves ("auto" on the card: K8,
   one launch per factor) and K1 for every product; within 5 % of the JAX
   package's block-mode iteration count, the plans' block reach, ms per
   ILUT apply beside the bytes bound of the two solves; the same solve
   capped at 40 iterations in block and in explicit "level" mode, ms per
   apply and per iteration side by side;
   16b. the same system by FGMRES with ``trisolve_mode="jacobi_bws"``:
   one K2 launch per Jacobi-sweep product on the strict factor;
17. PCG + IC(t), ``solve()``'s default for SPD n < 20,000, on
   fd_laplacian_2d(129), block solves (K8) under "auto";
26. K8 (``csrc/block_trisolve.cu``) against its twin on phase 16's ILUT
   factors and phase 17's IC factor and its transpose, f32 and f64:
   error bound, the launch geometry (cluster size, stages), CUDA-event
   times beside the bytes bounds (the plan's, its lower triangles', the
   factor's), the library call (``torch.triangular_solve`` of the factor
   as a sparse CSR tensor: cuSPARSE's SpSV) and the level-scheduled
   solve of the same factor;
18. GMRES + SA-AMG on phase 4's operator (n = 1,046,529) with MGS and with
   CGS2: at most 10 iterations, ms per iteration (the median of five
   frozen repeats) beside phase 4's PCG;
19. the direct solve on the card: ``solve()`` with n = 484 and
   ``DefaultDirect`` on a DiaMatrix, against scipy's ``spsolve``;
20. the block lane's GMRES (K4) and its CG with the scalar IC(t) (an f32
   factor in f64 block plans, K8), on fd_vector_laplacian_2d(64, b=5, coupling=0.2) (n =
   20,480);
21. mixed precision (f32 inner Krylov on the kernels, f64 refinement, the
   f64 oracle on the kernels in f64), banded: ``solve(..., precision=
   "mixed")`` with no device on phase 5's system, and PCG and GMRES with
   AMG(2, 6) on phase 4's operator (K1 f32 and f64), frozen re-solves
   beside phases 4 and 18;
22. mixed precision, unstructured: PCG + BWS SA-AMG on phase 7's FEM
   matrix unpermuted; the route packs its own RCM-ordered f32 BWS operator
   (K2 f32) and an f64 pack as the oracle (K2 f64); re-solves beside
   phase 7;
23. mixed precision, block lane at full width: "auto" with one
   right-hand side (K4 f32 inside, K4 f64 oracle) beside phase 10, and
   k = 8 through ``cg_lockstep_rr`` (K5 f32 and f64) beside phase 11;
24. mixed precision, geometric multigrid: ``hbm_solve.py``'s f32 route at
   m = 10239 (the f32 table and device-probed hierarchy, K6 f32 on the
   two finest levels, K1 f32 below, ``cg_solve_rr`` with two V-cycles, K6
   f64 on the f64 grid table as the oracle), beside phase 13, with a
   profiled repeat and the device time of the hi-dots and the f64 x
   update;
25. mixed precision, short: ``solve()`` on fd_convection_diffusion_2d(63)
   (GMRES + ILUT, the f64 FGMRES inner, f32 block plans on K8) gated on
   the JAX package's block-mode count;
27. Newton at the reference's sizes, no device argument: FuncAdapter1D on
   x² − 2 and arctan with SimpleBacktrack and TrivialLinesearch, and
   Bratu2D(m=100) with PCG + AMG(5, 2) inside (examples/bratu_example.py)
   at native and mixed precision (K1 f64; f32 and f64);
28. Newton at full width, ``benchmarks/bratu_large.py::run_ours`` at m =
   1023 (n = 1,046,529): the longdouble host outer loop, mixed PCG with
   the 6-level grid GMG probed on the card from the f32 Jacobian (K1 f32
   and f64; no level is wide enough for K6); setup, cold and steady
   walls, inner iterations per step and the host share of the wall;
29. ``newton_krylov_solve`` on Bratu m = 255, matrix-free (J·v by
   ``torch.func.jvp`` through K1's autograd.Function, every tangent a K1
   launch) and with the explicit Jacobian and its Jacobi preconditioner;
30. ``solve(A, B)`` with k = 8 on fd_laplacian_2d(150): lockstep CG and
   GMRES (ILUT by K8) at native and mixed precision (mixed GMRES without a
   restart and with restart=60), the column loop for orthog="cgs2", the
   direct solve at n = 484, and the mixed route on an unstructured FEM
   system of the same n (RCM-ordered BWS packs, K2 per column), the native
   and FEM routes beside k single ``solve()`` calls;
15. (run last, since a profiler session may leave host overhead on later
   launches) the unstructured path under ``torch.profiler``: phase 7's
   re-solve (busy share, K2's share, launches per iteration) and the
   device time alone of K2, K3 and the CSR call on its fine operator;
   then phase 16's solve capped at 40 iterations (busy share over the
   median unprofiled wall, device ops per iteration, the shares of K1, of
   K8, of MGS and of the ILUT applies); then phase 17's IC(t) apply by
   block and by level solves (device time and ops per apply).

Phases 27-30 gate on the JAX package's Newton steps, stop reasons and
iteration counts for the same calls (``tests/jax_newton_counts.py``, its
accelerator mode) and on host residuals (Newton: ||F|| <= r0·tau + tau in
f64 by scipy); a kernel's plain twin called with a CUDA tensor there fails
the run (``no_twin_on_cuda``).

Phases 16, 17, 20 and 25 run "auto", which is "block" on the card, with
the block path's degrade warnings turned into errors, and must launch K8.
Phases 16-25 gate on a CONVERGED stop, a host residual <= 1e-9 (scipy,
or the matrix-free stencil) and the error against x* (1e-6; 1e-5 on the
unstructured and block lanes), and print the iterations, ms per
iteration, the kernel launches and the solution's device.  Phases 21-24
allow at most MIXED_ITERS_FACTOR times the native iterations of the same
system and print the native phase's numbers beside their own, the f32
operator's dtype, the launches of each kernel in each dtype and the host
reads per iteration.

Then one JSON line on the kernels (each with its bound from the bytes it
must move and the operations it must do, and the time of the library
call, which the port itself never makes; ``launches`` counts the main
path's run, ``path_launches`` the runs of phases 16-30, by dtype for
21-30), and last the
device record ``{"ok": true, "device": {...}}``.

``--bws-sweep`` runs none of that: it builds copies of
``csrc/bws_spmv.cu`` with other sizes (threads per block, loads in flight
per thread, evict-first loads of values and indices; by default
``BWS_SWEEP``, the kept design first), checks each against the twin and
times it against the others and the CSR product (``bws_sweep``).
"""
import contextlib
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# K1 against its twin, as max|y_K1 - y_twin| / max|y_twin|.  Both add the D
# terms in the same order; they differ because nvcc contracts each
# multiply-add into one FMA (one rounding) where the twin rounds the
# product and the sum separately.  That is a few ulps of the partial sums,
# which stay within a small factor of max|y| on these operators.  The same
# bound holds K4, K5 (which adds its D·b terms in (q, d) order, the twin in
# (d, q): a reordering, again a few ulps of the partial sums) and K6.
TOL = {"float32": 1e-6, "float64": 1e-13}
# K2/K3 against their twin, as max|y_kernel - y_twin| / max|y_twin|.  The
# kernels sum a row's products over the device CSR (in column order, or
# strided over up to 256 threads and then by shuffles); the twin sums the
# pack's segments in torch's reduction order.  Up to a few hundred terms
# per row on the widest restrictor, a few ulps each, relative to max|y|.
BWS_TOL = {"float32": 1e-5, "float64": 1e-12}
# host-checked ||b - A x|| / ||b|| after a solve at tau = 1e-10
RESID_LIMIT = 1e-9
# ||x - x*|| / ||x*|| on the unstructured problem.  The error is bounded by
# kappa(A) times the residual; the FEM matrix at n = 1M has a condition
# number near 1e6 (h^-2, times the coefficient's contrast), so tau =
# 1e-10 leaves room for errors above the banded path's 1e-6 gate.
UNSTRUCTURED_ERR_LIMIT = 1e-5
# ||x - x*|| / ||x*|| on the block lane's vector Laplacian at m = 648: its
# condition number is a few 1e5 (h^-2 times the coupling block's
# (1 + 4c) / (1 - c)), so tau = 1e-10 leaves room above 1e-6 as well
BLOCK_ERR_LIMIT = 1e-5
# the block lane's configuration (benchmarks/bdia_solve_tpu.py:29-31, 52-55)
BLOCK_M, BLOCK_B, BLOCK_COUPLING, BLOCK_K = 648, 5, 0.2, 8
# block-Jacobi CG needs ~1,800 iterations there; solve()'s default is 1000
BLOCK_MAXITER = 6000
# the geometric-multigrid path (benchmarks/hbm_solve.py:88-169, :218): the
# grid width and the level count of its loop at :104-107
GRID_M, GRID_LEVELS = 10239, 10
# ||x - x*|| / ||x*|| there: kappa ~ 4e7 at m = 10239 times the residual
# would allow more, but the GMG-preconditioned error is far smaller
GRID_ERR_LIMIT = 1e-6
# run_large.py's GMG configuration: m = 1023, _mg_levels(1023) = 6
OO_GMG_M, OO_GMG_LEVELS = 1023, 6
# phases 16-20, GMRES, ILU(t)/IC(t) and the direct solve: the problem sizes
# and the iteration counts the JAX package takes for the same calls on the
# CPU in f64 (tau = 1e-10, b = A x*, x* from default_rng(2)), with its ILU
# applied by block solves as on its accelerator where the port's "auto"
# runs K8 (phases 16, 17, 20's IC and 25: tests/jax_block_mode_counts.py;
# equal to its level-mode counts at these sizes); the card must land
# within ITERS_SLACK of them
CD_M, CD_ITERS = 255, 617          # 16: fd_convection_diffusion_2d, GMRES+ILUT
IC_M, IC_ITERS = 129, 140          # 17: fd_laplacian_2d, PCG + IC(t)
GMRES_AMG_MAX_ITERS = 10           # 18: GMRES + SA-AMG at m = 1023 (JAX: 9)
DIRECT_M = 22                      # 19: n = 484, solve()'s direct route
DIRECT_ERR_LIMIT = 1e-12           # 19: against scipy's spsolve
BLOCK_GMRES_M = 64                 # 20: the block lane at n = 20,480
BLOCK_GMRES_ITERS, BLOCK_IC_ITERS = 205, 142
ITERS_SLACK = 0.05
# phases 21-25, the mixed-precision routes: at most this many times the
# native iterations of the same system (the JAX package's counts at these
# sizes are not taken on the CPU, and its CPU AMG smooths by Gauss-Seidel
# where the card's smooths by Jacobi); phase 25's size and JAX count
MIXED_ITERS_FACTOR = 1.5
CD_MIXED_M, CD_MIXED_ITERS = 63, 396
# phase 16's solve under the profiler (phase 15), capped at this many
# iterations
PROFILE_MAXITER = 40
# phases 27-30, Newton and solve(A, B): the JAX package's Newton steps and
# iteration counts for the same calls on the CPU in its accelerator mode
# (AMG smoothed by Jacobi, ILU(t)/IC(t) applied by block solves), as the
# port runs them on the card (tests/jax_newton_counts.py)
NEWTON_1D_STEPS = {"sqrt2 backtrack": (5, "CONVERGED"),
                   "sqrt2 trivial": (5, "CONVERGED"),
                   "arctan backtrack": (4, "CONVERGED"),
                   "arctan trivial": (9, "INNER_SOLVE_FAIL")}
BRATU_M = 100                      # 27: examples/bratu_example.py
BRATU_STEPS = {"native": (3, "CONVERGED"), "mixed": (3, "CONVERGED")}
# 28: benchmarks/bratu_large.py::run_ours at its default m = 1023 with
# _mg_levels(1023) = 6; the Newton steps of the JAX package's own record of
# this call (benchmarks/our_results/bratu_large_r5.jsonl)
BRATU_LARGE_M, BRATU_LARGE_LEVELS = 1023, 6
BRATU_LARGE_STEPS = (3, "CONVERGED")
# 29: the largest of m = 63, 127, 255 at which the JAX package's
# newton_krylov_solve converges with tests/test_newton_krylov.py's
# settings; (Newton steps, total CG iterations, reason)
NK_M = 255
NK_COUNTS = {"jvp": (6, 1669, "CONVERGED"),
             "explicit J + Jacobi": (4, 1294, "CONVERGED")}
# 30: k right-hand sides on phase 5's system, and an unstructured one of
# the same n
MULTI_M, MULTI_K, FEM_MULTI_M = 150, 8, 151
MULTI_ITERS = {"cg": 6, "gmres": 365, "cg mixed": 8,
               "gmres mixed restart=60": 2463, "gmres cgs2": 365,
               "direct": 1, "fem cg jacobi mixed": 619}
# 30, mixed GMRES without a restart (solve()'s default): each refinement
# pass is one f32 GMRES of up to 1000 steps, and a pass after the first can
# stagnate at its cap, so the JAX package's own total moves by whole passes
# when B moves by one f32 rounding (1559 on B, 1545 and 2240 on two such
# draws, tests/jax_newton_counts.py).  The gates: the first pass, per
# column, within ITERS_SLACK of JAX's; the total within ITERS_SLACK of one
# of JAX's three
MIXED_GMRES_PASS1 = (240, 240, 241, 240, 241, 238, 237, 240)
MIXED_GMRES_TOTALS = (1559, 1545, 2240)
KERNELS = ("dia_spmv", "bws_spmv", "lane_gather_probe", "bdia_spmv",
           "grid_dia_spmv", "block_trisolve")
# K8 against its twin, as max|x_K8 - x_twin| / max|x_twin|: the kernel sums
# each row's products by warp shuffles, the twin by torch's matrix-vector
# products, and the recurrence carries each block's rounding into the next
K8_TOL = {"float32": 1e-5, "float64": 1e-12}
# the block path's degrade warnings (linear/ilu.py), errors in phases 16,
# 17, 20 and 25
DEGRADE = r".*(not banded enough for the block|degrading to approximate)"
# K2's sizes for --bws-sweep: threads per block, loads in flight per
# thread, evict-first loads (1) or plain ones (0); the kept design first
BWS_SWEEP = ("256,4,1", "256,4,0", "128,4,1", "512,4,1", "256,8,1",
             "256,2,1", "256,2,0")
# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM3
# at 3.35 TB/s; 67 TFLOP/s in f32 and 34 TFLOP/s in f64 outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
# how torch words a refusal of an op for a dtype or a sparse layout
LIBRARY_REFUSAL = re.compile(r"not implemented|not supported|unsupported|"
                             r"layout|dtype|Sparse(Csr|Bsr)", re.IGNORECASE)


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


def time_pair(kernel, plain, library=None, runs=21, calls=10, warmup=3):
    """Milliseconds per call of each version: the median over ``runs``
    runs, each ``calls`` back-to-back calls between two CUDA events (so
    launch latency overlaps the previous call, as in a solver loop),
    timed in turns (plain, kernel, library, library, kernel, plain, ...)
    after a warm-up.  Each run starts with one untimed call, so that the
    start event is not recorded on an idle card while the host prepares
    the first timed call.  Returns (kernel, plain, library or None)."""
    import torch
    fns = {"plain": plain, "kernel": kernel}
    if library is not None:
        fns["library"] = library
    for _ in range(warmup):
        for fn in fns.values():
            fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for r in range(runs):
        order = list(fns.items())
        for name, fn in (order if r % 2 == 0 else order[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            fn()
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / calls)
    med = {name: statistics.median(t) for name, t in times.items()}
    return med["kernel"], med["plain"], med.get("library")


def bound(nbytes, flops, dt):
    """The least time the card could take for a call (kernels-record
    keys): each input byte read once and each output byte written once
    over the HBM rate, or the operations over the peak rate of their type,
    whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dt]
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def try_library(call):
    """(call, None) when torch takes the library call, else (None, its
    error) when torch refuses it for its dtype or layout.  Any other
    failure (out of memory, a CUDA error) raises.  The call is a yardstick
    timed beside a kernel; the port never makes it."""
    import torch
    try:
        call()
        torch.cuda.synchronize()
    except NotImplementedError as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    except RuntimeError as e:
        msg = str(e)
        if (isinstance(e, torch.cuda.OutOfMemoryError) or "CUDA error" in msg
                or not LIBRARY_REFUSAL.search(msg)):
            raise
        return None, f"{type(e).__name__}: {msg.splitlines()[0][:160]}"
    return call, None


def library_fields(name, lib_ms, error):
    """The kernels-record keys of a library call."""
    out = dict(library_ms=lib_ms, library_call=name)
    if error is not None:
        out["library_error"] = error
    return out


def lib_text(name, lib_ms, error):
    return (f"library {name} {lib_ms:.4f} ms" if error is None
            else f"library {name} refused ({error})")


def csr_of_host(H, dtype, device):
    """torch.sparse_csr_tensor of a HostCSR (int32 indices) on device."""
    import torch
    return torch.sparse_csr_tensor(
        torch.as_tensor(H.indptr.astype(np.int32), device=device),
        torch.as_tensor(H.indices.astype(np.int32), device=device),
        torch.as_tensor(H.data, dtype=dtype, device=device),
        size=tuple(H.shape))


def csr_of_dia(A):
    """torch.sparse_csr_tensor of a DiaMatrix, built on its device from
    the diagonal table (stored zeros dropped; int32 indices)."""
    import torch
    n, nc = A.shape
    order = sorted(range(len(A.offsets)), key=lambda d: A.offsets[d])
    offs = torch.tensor([A.offsets[d] for d in order], device=A.device)
    cols = torch.arange(n, device=A.device)[:, None] + offs[None, :]
    vals = (A.diags if order == sorted(order) else A.diags[order])[:, :n].T
    keep = (cols >= 0) & (cols < nc) & (vals != 0)
    crow = torch.zeros(n + 1, dtype=torch.int32, device=A.device)
    crow[1:] = keep.sum(1).cumsum(0)
    col = cols[keep].to(torch.int32)
    del cols
    return torch.sparse_csr_tensor(crow, col, vals[keep], size=(n, nc))


def bsr_of_bdia(A):
    """torch.sparse_bsr_tensor of a BdiaMatrix in node-major order,
    blocksize (b, b), built on its device from the planes (int32
    indices)."""
    import torch
    b, nb, D = A.b, A.nb, len(A.offsets)
    order = sorted(range(D), key=lambda d: A.offsets[d])
    P = A.planes[:, :, :nb].reshape(D, b, b, nb)[order]     # [d, q, p, i]
    blocks = P.permute(3, 0, 2, 1)                         # [i, d, p, q]
    offs = torch.tensor([A.offsets[d] for d in order], device=A.device)
    cols = torch.arange(nb, device=A.device)[:, None] + offs[None, :]
    keep = (cols >= 0) & (cols < nb)
    crow = torch.zeros(nb + 1, dtype=torch.int32, device=A.device)
    crow[1:] = keep.sum(1).cumsum(0)
    return torch.sparse_bsr_tensor(crow, cols[keep].to(torch.int32),
                                   blocks[keep].contiguous(),
                                   size=tuple(A.shape))


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


def library_agrees(kernel_out, lib_out, tol, what):
    """The library call computes the kernel's function: its result within
    10 tol of the kernel's, relative to max|y| (else the yardstick, or its
    conversion here, is wrong and the script fails)."""
    rel = float((kernel_out - lib_out).abs().max()
                / kernel_out.abs().max())
    if not rel <= 10 * tol:
        raise SystemExit(f"the library call of {what} disagrees with the "
                         f"kernel: rel {rel:.3e} > {10 * tol:g}")
    return rel


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
            dts = str(dt).split(".")[1]
            A = DiaMatrix.from_host_csr(H, dtype=dt, device=device)
            x = torch.as_tensor(xh, dtype=dt, device=device)
            y = spmv.dia_spmv(A, x)
            y_ref = spmv.dia_spmv_torch(A, x)
            torch.cuda.synchronize()
            abs_err = float((y - y_ref).abs().max())
            rel = abs_err / float(y_ref.abs().max())
            tol = TOL[dts]
            ok = bool(torch.isfinite(y).all()) and rel <= tol
            S = csr_of_host(H, dt, device)
            lib, lib_err = try_library(lambda: S @ x)
            if lib is not None:
                library_agrees(y, lib(), tol, f"K1 {name} {dts}")
            ms, plain_ms, lib_ms = time_pair(
                lambda: spmv.dia_spmv(A, x), lambda: spmv.dia_spmv_torch(A, x),
                lib)
            D, n = len(A.offsets), A.n_rows
            size = A.diags.element_size()
            nbytes = D * n * size + (A.n_cols + n) * size
            bnd = bound(nbytes, 2 * H.nnz, dts)
            phase(3, f"K1 {name} {dts} shape={A.shape} D={D} "
                     f"rel_err={rel:.3e} (tol {tol:g}) K1 {ms:.4f} ms "
                     f"{H.nnz / (ms * 1e-3):.4e} nnz/s "
                     f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s, bound "
                     f"{bnd['bound_ms']:.4f} ms | twin {plain_ms:.4f} ms "
                     f"{H.nnz / (plain_ms * 1e-3):.4e} nnz/s | "
                     f"{lib_text('CSR @ x', lib_ms, lib_err)} | {card}")
            if not ok:
                raise SystemExit(f"K1 disagrees with its twin on {name} "
                                 f"{dt}: rel {rel:.3e} > {tol:g}")
            if name.startswith("main-path") and dt == torch.float64:
                record = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                              **bnd, **library_fields(
                                  "torch.sparse_csr_tensor @ x", lib_ms,
                                  lib_err))
            del A, x, y, y_ref, S, lib
    return record


def device_tensors(op):
    """The tensors of a DiaMatrix, EllMatrix or BwsMatrix (its device CSR
    included)."""
    import torch
    out = []
    for v in vars(op).values():
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif dataclasses.is_dataclass(v):
            out += device_tensors(v)
    return out


def check_solution(tag, H, b, x_star, st, device, err_limit=1e-6):
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
    if not st.success or resid > RESID_LIMIT or err > err_limit:
        raise SystemExit(f"{tag}: success={st.success} resid={resid:.3e} "
                         f"err={err:.3e}")
    return resid, err


def main_path(device, m=1023):
    """Phase 4: run_large.py's SA configuration through the factory API.
    Returns the K1 launches and the frozen re-solve's ms per iteration."""
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
    reset_launches()
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
    return launches, dict(ms_per_iter=1e3 * solve_s / st2.iters,
                          solve_s=solve_s, iters=st2.iters)


def front_end(device, m=150):
    """Phase 5: solve() with every argument but tau at its default, the
    device included: the solution must come back on ``device``."""
    import torch
    import pysolvers_tpu_torch as pt
    from pysolvers_tpu_torch.ops import spmv
    H = pt.problems.fd_laplacian_2d(m)
    x_star = np.random.default_rng(3).random(H.shape[0])
    b = H.matvec(x_star)
    reset_launches()
    t0 = time.perf_counter()
    # no device: the port solves on the card by default
    st = pt.solve(H, b, tau=1e-10)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = spmv.dia_spmv_launches
    resid, err = check_solution("solve()", H, b, x_star, st, device)
    if launches <= 0:
        raise SystemExit("solve() launched K1 no time")
    phase(5, f"solve() fd_laplacian_2d({m}) n={H.shape[0]} with no device "
             f"argument: solution on {st.soln.device}, {wall:.3f} s "
             f"iters={st.iters} reason={st.reason.name} K1 launches="
             f"{launches} host rel resid={resid:.3e} err={err:.3e}")
    return dict(wall=wall, iters=st.iters, err=err)


def reset_launches():
    """Every kernel's launch count to 0, the counts by dtype included."""
    from pysolvers_tpu_torch.ops import _cuda_build, block_trisolve
    from pysolvers_tpu_torch.ops import bws_spmv, grid_spmv, probe, spmv
    _cuda_build.launches_by_dtype.clear()
    block_trisolve.block_trisolve_launches = 0
    spmv.dia_spmv_launches = spmv.dia_spmv_jvp_launches = 0
    spmv.bdia_spmv_launches = spmv.bdia_spmm_launches = 0
    bws_spmv.bws_spmv_launches = bws_spmv.bws_spmv_classes_launches = 0
    probe.lane_gather_probe_launches = 0
    grid_spmv.grid_dia_spmv_launches = 0


def launches():
    from pysolvers_tpu_torch.ops import block_trisolve, bws_spmv, grid_spmv
    from pysolvers_tpu_torch.ops import probe, spmv
    return dict(K1=spmv.dia_spmv_launches, K2=bws_spmv.bws_spmv_launches,
                K3=bws_spmv.bws_spmv_classes_launches,
                K4=spmv.bdia_spmv_launches, K5=spmv.bdia_spmm_launches,
                K6=grid_spmv.grid_dia_spmv_launches,
                K7=probe.lane_gather_probe_launches,
                K8=block_trisolve.block_trisolve_launches)


def build_kernels():
    """Phase 2: one nvcc per source, all started together."""
    from pysolvers_tpu_torch.ops import _cuda_build

    def build(name):
        t0 = time.perf_counter()
        so = _cuda_build.build(name)
        return so, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = dict(zip(KERNELS, pool.map(build, KERNELS)))
    wall = time.perf_counter() - t0
    for name, (so, secs) in built.items():
        regs, spills, kernel, k5 = {}, 0, None, {}
        with open(os.path.join(_cuda_build.BUILD_DIR, f"lib{name}.log")) as f:
            for ln in f:
                if "Compiling entry function" in ln:
                    kernel = ln.split("'")[1] if "'" in ln else ln.strip()
                spills += sum(int(s) for s in
                              re.findall(r"(\d+) bytes spill", ln))
                used = re.search(r"Used (\d+) registers", ln)
                if used:
                    regs[kernel] = int(used.group(1))
                    # K5's instantiations bdia_spmm_kernel<T, PB, K>
                    inst = re.search(
                        r"bdia_spmm_kernelI([df])Li(\d+)ELi(\d+)E",
                        kernel or "")
                    if inst:
                        k5["%s%s,%s" % inst.groups()] = regs[kernel]
        phase(2, f"built {os.path.relpath(so, ROOT)} in {secs:.2f} s; "
                 f"{len(regs)} kernels, registers {min(regs.values())}.."
                 f"{max(regs.values())}, spill bytes {spills}")
        if k5:
            phase(2, f"K5 registers per instantiation (f|d PB,K): {k5}")
        # K5 keeps PB * K accumulators in registers by design: a spill
        # there is a fault of the kernel's sizing, not a tuning matter
        if spills and name == "bdia_spmv":
            raise SystemExit(f"ptxas reports {spills} spill bytes in "
                             f"lib{name} (see lib{name}.log)")
    phase(2, f"all {len(KERNELS)} builds in {wall:.2f} s")


def probe_k7(device):
    """Phase 6: the probe's own run (counts read around it), then K7
    against its twin.  Returns the kernels-record numbers."""
    import torch
    from pysolvers_tpu_torch.ops import probe
    reset_launches()
    err = probe.probe_main(device)
    n = launches()["K7"]
    if err != 0.0 or n != 1:
        raise SystemExit(f"K7: int16 lane-index gather max err {err}, "
                         f"{n} launches")
    rng = np.random.default_rng(1)
    idx = torch.as_tensor(rng.integers(0, 128, size=(8, 128)),
                          dtype=torch.int16, device=device)
    x = torch.as_tensor(rng.random((8, 128)), dtype=torch.float32,
                        device=device)
    idx64 = idx.to(torch.int64)
    out = probe.lane_gather_probe(idx, x)
    if not (torch.equal(out, probe.lane_gather_probe_torch(idx, x))
            and torch.equal(out, torch.gather(x, 1, idx64))):
        raise SystemExit("K7 disagrees with its twin")
    ms, plain_ms, lib_ms = time_pair(
        lambda: probe.lane_gather_probe(idx, x),
        lambda: probe.lane_gather_probe_torch(idx, x),
        lambda: torch.gather(x, 1, idx64))
    probe.check_lane_indices(device)
    bnd = bound(idx.numel() * (2 + 4 + 4), 0, "float32")
    phase(6, f"K7 int16 lane indices widened to int32: OK, bit-exact "
             f"against numpy and the twin (max err {err}); K7 {ms:.4f} ms "
             f"(bound {bnd['bound_ms']:.2e} ms) | twin {plain_ms:.4f} ms | "
             f"library torch.gather {lib_ms:.4f} ms | {card_line()}")
    return dict(launches=n, max_abs_err=err, ms=ms, plain_ms=plain_ms, **bnd,
                **library_fields("torch.gather(x, 1, idx_int64)", lib_ms,
                                 None))


def unstructured_path(device, m=1025, num_levels=4):
    """Phase 7: benchmarks/unstructured_amg.py's pipeline (RCM-reordered
    FEM matrix, x* from default_rng(7), b = A x*) through the factory API
    with a (host, BwsMatrix) pair, native f64.  Returns the problem (Ap,
    A_bws, b), the solver (hierarchy inside), the launches and the median
    re-solve seconds and iterations."""
    import torch
    import pysolvers_tpu_torch as pt
    from pysolvers_tpu_torch.sparse.bws import BwsMatrix
    from pysolvers_tpu_torch.utils.timing import Timer
    t0 = time.perf_counter()
    A = pt.problems.fem_poisson_2d_unstructured(m, seed=3)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    Ap = A.permute_symmetric(BwsMatrix._rcm_perm(A))
    rcm_s = time.perf_counter() - t0
    x_star = np.random.default_rng(7).normal(size=Ap.shape[0])
    b = Ap.matvec(x_star)
    t0 = time.perf_counter()
    A_bws = BwsMatrix.from_host_csr(Ap, dtype=np.float64, use_rcm=False,
                                    device=device)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    num_iters = 2
    solver = pt.PCG(pt.CommonSolverArgs(maxiter=500, tau=1e-10),
                    precond=pt.AMG(num_iters=num_iters, num_levels=num_levels,
                                   galerkin="host", matrix_format="bws"),
                    device=device).make_solver()
    Timer.reset()
    reset_launches()
    t0 = time.perf_counter()
    st = solver.solve((Ap, A_bws), b)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = launches()
    h = solver._formed_prec.state
    levels = h.levels[1:]
    fmt = [(tuple(L.A_dev.shape), type(L.A_dev).__name__,
            type(L.P_dev).__name__, type(L.R_dev).__name__) for L in levels]
    if levels[-1].A_dev is not A_bws:
        raise SystemExit("the hierarchy did not reuse the caller's fine pack")
    tensors = [h.A0_inv, *device_tensors(A_bws)]
    for L in levels:
        for op in (L.A_dev, L.P_dev, L.R_dev):
            if max(op.shape) >= 2000 and not isinstance(op, BwsMatrix):
                raise SystemExit(f"operator {op.shape} is "
                                 f"{type(op).__name__}, not BWS")
            tensors += device_tensors(op)
        tensors.append(L.dinv)
    if any(t.device.type != device for t in tensors):
        raise SystemExit("an operator of the unstructured solve is not on "
                         "the device")
    resid, err = check_solution("unstructured path", Ap, b, x_star, st,
                                device, UNSTRUCTURED_ERR_LIMIT)
    # every BWS product is one K2 launch over the device CSR; the class
    # entry K3 has no padded segments to skip there and is on no path
    products = bws_products(h, A_bws, st.iters, num_iters)
    if counts["K2"] != products or products <= 0 or counts["K3"]:
        raise SystemExit(f"the unstructured path made {products} BWS "
                         f"products and launched {counts}")
    ops = {id(op): op for op in [A_bws] + [o for L in levels for o in (
        L.A_dev, L.P_dev, L.R_dev)] if isinstance(op, BwsMatrix)}
    csr_bytes = sum(op.csr.nbytes for op in ops.values())
    pack_bytes = sum(t.numel() * t.element_size() for op in ops.values()
                     for t in (op.data, op.lidx, op.delta))
    solver.freeze_matrix()
    solver.freeze_prec()
    # the host sets this path's pace, and a shared host varies: the median
    # of five re-solves
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        st2 = solver.solve((Ap, A_bws), b)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    solve_s = statistics.median(walls)
    check_solution("unstructured re-solve", Ap, b, x_star, st2, device,
                   UNSTRUCTURED_ERR_LIMIT)
    phase(7, f"PCG+AMG(num_iters=2, num_levels={num_levels}, "
             f"matrix_format='bws') fem_poisson_2d_unstructured({m}, "
             f"seed=3) RCM f64 n={Ap.shape[0]} nnz={Ap.nnz}: iters="
             f"{st.iters} reason={st.reason.name} host rel resid="
             f"{resid:.3e} err vs x*={err:.3e} (limit "
             f"{UNSTRUCTURED_ERR_LIMIT:g})")
    phase(7, f"levels (A shape, A/P/R formats), coarsest "
             f"{tuple(h.A0_inv.shape)} dense: {fmt}; smoother={h.smoother}")
    phase(7, f"host: FEM generation {gen_s:.3f} s, RCM+permute "
             f"{rcm_s:.3f} s, fine pack+upload {pack_s:.3f} s; first solve "
             f"{first_s:.3f} s = SA hierarchy "
             f"{Timer.total('amg.host_hierarchy'):.3f} s + device lowering "
             f"{Timer.total('amg.device_lower'):.3f} s (of it BWS packs "
             f"{Timer.total('amg.bws_pack'):.3f} s, device CSR included) + "
             f"PCG; frozen re-solve {1e3 * solve_s:.3f} ms, the median of "
             f"{[round(1e3 * w, 3) for w in walls]} ({st2.iters} iters); "
             f"BWS products {products}, launches {counts} | "
             f"{card_line()}")
    phase(7, f"device bytes of the {len(ops)} BWS operators: CSR layouts "
             f"{csr_bytes / 1e6:.1f} MB (fine operator "
             f"{A_bws.csr.nbytes / 1e6:.1f} MB, {A_bws.csr.n_blocks} row "
             f"blocks), pack tables {pack_bytes / 1e6:.1f} MB")
    return dict(A=A, Ap=Ap, A_bws=A_bws, solver=solver, counts=counts, b=b,
                solve_s=solve_s, iters=st2.iters, err=err)


def bws_products(h, A_fine, iters, num_iters):
    """The BWS products of a PCG solve on A_fine preconditioned by
    ``num_iters`` V-cycles of h: one product with A_fine and one
    preconditioner apply at the start and in every iteration
    (``krylov.cg_solve``); a V-cycle applies each level's A nu_pre +
    nu_post + 1 times and its R and P once (``amg.v_cycle``, Jacobi)."""
    from pysolvers_tpu_torch.sparse.bws import BwsMatrix

    def bws(op):
        return int(isinstance(op, BwsMatrix))
    if h.smoother != "jacobi":
        raise SystemExit(f"the unstructured path smooths by {h.smoother}, "
                         f"not jacobi")
    per_cycle = sum((h.nu_pre + h.nu_post + 1) * bws(L.A_dev) + bws(L.R_dev)
                    + bws(L.P_dev) for L in h.levels[1:])
    return (iters + 1) * (bws(A_fine) + num_iters * per_cycle)


def bws_operators(Ap, A_bws, solver, num_levels):
    """(name, HostCSR, f64 pack) of every BWS operator of the unstructured
    hierarchy, fine first; the host operators are rebuilt (the SA setup
    is deterministic) to pack them in f32 as well."""
    from pysolvers_tpu_torch.linear.amg import build_sa_hierarchy
    from pysolvers_tpu_torch.sparse.bws import BwsMatrix
    mlh = build_sa_hierarchy(Ap, num_levels)
    h = solver._formed_prec.state
    ops = [("fine A", Ap, A_bws)]
    for k in range(len(mlh.matrices) - 1, 0, -1):
        L = h.levels[k]
        n = mlh.matrices[k].shape[0]
        if k < len(mlh.matrices) - 1:
            ops.append((f"A n={n}", mlh.matrices[k], L.A_dev))
        ops.append((f"P to n={n}", mlh.prolongators[k - 1], L.P_dev))
        ops.append((f"R from n={n}", mlh.restrictions[k - 1], L.R_dev))
    for name, H, op in ops:
        if tuple(op.shape) != tuple(H.shape):
            raise SystemExit(f"{name}: host {H.shape} against device "
                             f"{op.shape}")
    # operators below the packing threshold keep the auto format
    return [o for o in ops if isinstance(o[2], BwsMatrix)]


def device_ms(fn, calls=20, tries=3):
    """Device milliseconds per call of fn: the CUDA kernels' self time
    under torch.profiler over ``calls`` calls, host time excluded.  Every
    call launches a kernel, so a trace with fewer kernels than calls lost
    events and is taken again, up to ``tries`` times (then None)."""
    for _ in range(tries):
        _, dev_s, rows = profile_call(lambda: [fn() for _ in range(calls)])
        if sum(c for _, k, c in rows if not k.startswith("Mem")) >= calls:
            return 1e3 * dev_s / calls
    return None


def host_us(fn, calls=20):
    """Host microseconds per call of fn: the enqueue of ``calls`` calls
    after a synchronize, without waiting for the card (the queue does not
    fill at this count)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * wall / calls


def check_bws(name, H, A, x, runs, entry="K2", library=False):
    """One K2 (``bws_spmv``) or K3 (``bws_spmv_by_class``) comparison and
    timing line (with ``library``, the CSR of H in pack order timed beside
    it, and the host time per call of both); returns the numbers."""
    import torch
    from pysolvers_tpu_torch.ops import bws_spmv
    fn = bws_spmv.bws_spmv if entry == "K2" else bws_spmv.bws_spmv_by_class
    y = fn(A, x)
    y_ref = bws_spmv.bws_spmv_torch(A, x)
    torch.cuda.synchronize()
    abs_err = float((y - y_ref).abs().max())
    rel = abs_err / float(y_ref.abs().max())
    dt = str(A.dtype).split(".")[1]
    tol = BWS_TOL[dt]
    ok = bool(torch.isfinite(y).all()) and rel <= tol
    lib, lib_err, lib_line = None, None, ""
    if library:
        if not torch.equal(A.perm.cpu(), torch.arange(H.shape[0],
                                                      dtype=A.perm.dtype)):
            raise SystemExit(f"{name}: the pack is not in H's order")
        S = csr_of_host(H, A.dtype, x.device)
        lib, lib_err = try_library(lambda: S @ x)
        if lib is not None:
            library_agrees(y, lib(), tol, f"{entry} {name} {dt}")
    ms, plain_ms, lib_ms = time_pair(
        lambda: fn(A, x), lambda: bws_spmv.bws_spmv_torch(A, x), lib,
        runs=runs)
    if library:
        lib_line = f" | {lib_text('CSR @ x', lib_ms, lib_err)}"
        lib_line += (f" || host time per call {entry} "
                     f"{host_us(lambda: fn(A, x)):.1f} us, CSR @ x "
                     f"{lib and host_us(lib)} us")
    L = A.csr
    size = A.data.element_size()
    # the bytes the layout makes the kernel read and write: a rate, not a
    # bound (int64 row pointers past 2^31 nonzeros; K3 reads its block list)
    read_bytes = ((size + 4) * L.nnz + L.indptr.element_size()
                  * (A.n_rows + 1) + 4 * (L.n_blocks + 1)
                  + size * (A.n_cols + A.n_rows)
                  + (4 * L.n_blocks if entry == "K3" else 0))
    # the bound is the operator's, one for K2 and K3: the CSR minimum
    # (values and int32 column indices, row pointers, x read, y written)
    nbytes = ((size + 4) * L.nnz + 4 * (A.n_rows + 1)
              + size * (A.n_cols + A.n_rows))
    bnd = bound(nbytes, 2 * L.nnz, dt)
    phase(8, f"{entry} {name} {dt} shape={A.shape} nnz={L.nnz} row blocks="
             f"{L.n_blocks} classes={[(s, len(i)) for s, i in A.s_classes]} "
             f"rel_err={rel:.3e} (tol {tol:g}) {entry} {ms:.4f} ms "
             f"{L.nnz / (ms * 1e-3):.4e} nnz/s layout "
             f"{read_bytes / (ms * 1e-3) / 1e9:.1f} GB/s, bound "
             f"{bnd['bound_ms']:.4f} ms ({100 * bnd['bound_ms'] / ms:.1f} %) "
             f"| twin {plain_ms:.4f} ms{lib_line}")
    if not ok:
        raise SystemExit(f"{entry} disagrees with its twin on {name} {dt}: "
                         f"rel {rel:.3e} > {tol:g}")
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, **bnd,
                **library_fields("torch.sparse_csr_tensor @ x (pack order)",
                                 lib_ms, lib_err))


def check_bws_kernels(ops, device, rgg_n=1_000_000):
    """Phase 8.  Returns the kernels-record numbers of K2 and K3 at the
    main path's fine operator in f64 (K3's with its launches in one product
    by class there: no solve path launches it), and the fine operator's
    f32 pack."""
    import torch
    from pysolvers_tpu_torch.ops import bws_spmv
    from pysolvers_tpu_torch.problems import graph_laplacian_rgg
    from pysolvers_tpu_torch.sparse.bws import BwsMatrix
    rng = np.random.default_rng(0)
    rec = {}
    for i, (name, H, A64) in enumerate(ops):
        xh = rng.standard_normal(H.shape[1])
        for dt in (torch.float64, torch.float32):
            if dt == torch.float64:
                A = A64
            else:
                # the f64 pack's geometry, so both types run one layout
                A = BwsMatrix.from_host_csr(
                    H, dtype=np.float32, use_rcm=False,
                    group_rows=A64.group_rows, gt=A64.gt, device=device)
            x = torch.as_tensor(xh, dtype=dt, device=device)
            main = i == 0 and dt == torch.float64
            runs = 21 if main else 5
            r = check_bws(name, H, A, x, runs, library=i == 0)
            if main:
                rec["K2"] = r
            if i == 0 and dt == torch.float32:
                fine32 = A
            if i == 0:
                r = check_bws(name, H, A, x, runs, "K3", library=True)
                if main:
                    reset_launches()
                    bws_spmv.bws_spmv_by_class(A, x)
                    torch.cuda.synchronize()
                    rec["K3"] = dict(
                        r, launches_per_by_class_call=launches()["K3"])
            del A, x
    t0 = time.perf_counter()
    G = graph_laplacian_rgg(rgg_n, seed=1)
    gen_s = time.perf_counter() - t0
    try:
        G64 = BwsMatrix.from_host_csr(G, dtype=np.float64, use_rcm=True,
                                      device=device)
    except ValueError as e:
        phase(8, f"graph_laplacian_rgg({rgg_n}) not checked: its pack "
                 f"overflows the BWS window ({e})")
    else:
        x = torch.as_tensor(rng.standard_normal(rgg_n), device=device)
        for entry in ("K2", "K3"):
            check_bws(f"graph_laplacian_rgg({rgg_n}) RCM (generated in "
                      f"{gen_s:.1f} s)", G, G64, x, 5, entry)
    return rec, fine32


def block_operator(device):
    """The block lane's full-width operator: host matrix, f64 pack on the
    card, and the host seconds of generation and of pack + upload."""
    import torch
    import pysolvers_tpu_torch as pt
    t0 = time.perf_counter()
    H = pt.fd_vector_laplacian_2d(BLOCK_M, b=BLOCK_B, coupling=BLOCK_COUPLING)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    A = pt.BdiaMatrix.from_host_csr(H, BLOCK_B, device=device)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    return H, A, gen_s, pack_s


def check_bdia(name, A, rng, ks, runs, library=()):
    """K4 and K5 (at each k of ``ks``) against their twins on A, with
    CUDA-event times; for K4 (k = None) and each k in ``library``, the BSR
    product in node-major order timed beside them.  Returns {"K4":
    numbers, ("K5", k): numbers}."""
    import torch
    from pysolvers_tpu_torch.ops import spmv
    dt = str(A.dtype).split(".")[1]
    tol = TOL[dt]
    size = A.planes.element_size()
    b, nb, D = A.b, A.nb, len(A.offsets)
    plane_bytes = D * b * b * nb * size
    S = bsr_of_bdia(A) if library else None
    out = {}
    for k in (None,) + tuple(ks):
        if k is None:
            v = torch.as_tensor(rng.standard_normal(A.n_cols), dtype=A.dtype,
                                device=A.device)
            kernel = lambda: spmv.bdia_spmv(A, v)            # noqa: E731
            plain = lambda: spmv.bdia_spmv_torch(A, v)       # noqa: E731
            tag, nvec = "K4", 1
            # planar x -> node-major x, outside the timed window
            v_nm = v.reshape(b, nb).T.contiguous().reshape(-1)
            call = "torch.sparse_bsr_tensor (b, b) @ x"
        else:
            v = torch.as_tensor(rng.standard_normal((k, A.n_cols)),
                                dtype=A.dtype, device=A.device)
            kernel = lambda: spmv.bdia_spmm_rows(A, v)       # noqa: E731
            plain = lambda: spmv.bdia_spmm_torch(A, v)       # noqa: E731
            tag, nvec = f"K5 k={k}", k
            v_nm = v.reshape(k, b, nb).permute(2, 1, 0).reshape(
                nb * b, k).contiguous()
            call = f"torch.sparse_bsr_tensor (b, b) @ X (n, {k})"
        y, y_ref = kernel(), plain()
        torch.cuda.synchronize()
        abs_err = float((y - y_ref).abs().max())
        rel = abs_err / float(y_ref.abs().max())
        ok = bool(torch.isfinite(y).all()) and rel <= tol
        lib, lib_err, lib_line = None, None, ""
        if S is not None and (k is None or k in library):
            lib, lib_err = try_library(lambda: S @ v_nm)
            if lib is not None:
                # node-major result -> planar rows
                y_lib = lib().reshape(nb, b, -1).permute(2, 1, 0).reshape(
                    y.shape)
                library_agrees(y, y_lib, tol, f"{tag} {name} {dt}")
        ms, plain_ms, lib_ms = time_pair(kernel, plain, lib, runs=runs)
        if S is not None and (k is None or k in library):
            short = "BSR @ x" if k is None else f"BSR @ X (n, {k})"
            lib_line = f" | {lib_text(short, lib_ms, lib_err)}"
        nbytes = plane_bytes + 2 * nvec * A.n_rows * size
        bnd = bound(nbytes, 2 * D * b * b * nb * nvec, dt)
        phase(9, f"{tag} {name} {dt} b={b} nb={nb} nb_pad={A.nb_pad} "
                 f"offsets={A.offsets if D < 8 else D} "
                 f"rel_err={rel:.3e} (tol {tol:g}) {tag.split()[0]} {ms:.4f} ms "
                 f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s, bound "
                 f"{bnd['bound_ms']:.4f} ms | twin "
                 f"{plain_ms:.4f} ms {nbytes / (plain_ms * 1e-3) / 1e9:.1f} "
                 f"GB/s{lib_line}")
        if not ok:
            raise SystemExit(f"{tag} disagrees with its twin on {name} {dt}: "
                             f"rel {rel:.3e} > {tol:g}")
        out["K4" if k is None else ("K5", k)] = dict(
            max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, **bnd,
            **library_fields(call, lib_ms, lib_err))
        del v, v_nm, y, y_ref, lib
    return out


def check_bdia_kernels(A64, device):
    """Phase 9.  Returns the kernels-record numbers of K4 and K5 (k = 8) on
    the full-width operator in f64."""
    from pysolvers_tpu_torch import convert
    from pysolvers_tpu_torch.linear.block_precond import (
        block_jacobi_bdia_matrix)
    rng = np.random.default_rng(0)
    card = card_line()
    rec = check_bdia("full width", A64, rng, (1, 8, 16, 20), runs=21,
                     library=(BLOCK_K,))
    check_bdia("full width", A64.astype("float32"), rng, (BLOCK_K,), runs=11,
               library=(BLOCK_K,))
    M = block_jacobi_bdia_matrix(A64)
    for dt in ("float64", "float32"):
        check_bdia("block-Jacobi inverse (D = 1)", M.astype(dt), rng,
                   (BLOCK_K,), runs=11, library=(BLOCK_K,))
    nb, b, offsets = 1001, 3, (-37, -1, 0, 2, 37)
    planes = rng.standard_normal((len(offsets) * b, b, 1024))
    R = convert.bdia_from_arrays(planes, offsets, (nb * b, nb * b), b,
                                 device=device)
    for dt in ("float64", "float32"):
        check_bdia("random nonsymmetric", R.astype(dt), rng, (1, 8, 16, 20),
                   runs=5)
    phase(9, f"all K4/K5 checks passed | {card}")
    return dict(K4=rec["K4"], K5=rec[("K5", BLOCK_K)])


def block_single(H, A, device, gen_s, pack_s):
    """Phase 10: solve(BdiaMatrix, b) at full width, precond "auto" and
    "bmg"; each solved twice (the second hits the preconditioner cache).
    Returns the K4 launches of the "auto" solve."""
    import torch
    import importlib
    import pysolvers_tpu_torch as pt
    from pysolvers_tpu_torch.utils.timing import Timer
    tsolve = importlib.import_module("pysolvers_tpu_torch.solve")
    x_star = np.random.default_rng(0).random(H.shape[0])
    b = H.matvec(x_star)
    phase(10, f"fd_vector_laplacian_2d({BLOCK_M}, b={BLOCK_B}, coupling="
              f"{BLOCK_COUPLING}) f64 n={H.shape[0]} nnz={H.nnz} planes "
              f"{tuple(A.planes.shape)} ({A.planes.numel() * 8 / 1e6:.1f} MB)"
              f": generation {gen_s:.3f} s, pack + upload {pack_s:.3f} s")
    k4 = None
    for precond in ("auto", "bmg"):
        Timer.reset()
        reset_launches()
        t0 = time.perf_counter()
        st = pt.solve(A, b, tau=1e-10, maxiter=BLOCK_MAXITER,
                      precond=precond)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = launches()
        resid, err = check_solution(f"block solve ({precond})", H, b, x_star,
                                    st, device, BLOCK_ERR_LIMIT)
        if counts["K4"] <= 0:
            raise SystemExit(f"the block solve ({precond}) launched K4 no "
                             "time")
        t0 = time.perf_counter()
        st2 = pt.solve(A, b, tau=1e-10, maxiter=BLOCK_MAXITER,
                       precond=precond)
        torch.cuda.synchronize()
        repeat_s = time.perf_counter() - t0
        check_solution(f"block re-solve ({precond})", H, b, x_star, st2,
                       device, BLOCK_ERR_LIMIT)
        levels = ""
        if precond == "bmg":
            h = tsolve._BDIA_SOLVE_CACHE[id(A.planes)][("prec", "bmg")
                                                       ].state[0]
            sizes = [int(h.A0_inv.shape[0])] + [L.A_dev.shape[0]
                                                for L in h.levels[1:]]
            levels = (f", level sizes per dof {sizes}, of it coarsest "
                      f"dense inverses "
                      f"{Timer.total('amg.coarse_inverse'):.3f} s")
        phase(10, f"solve(BdiaMatrix, b, precond={precond!r}) iters="
                  f"{st.iters} reason={st.reason.name} host rel resid="
                  f"{resid:.3e} err vs x*={err:.3e} (limit "
                  f"{BLOCK_ERR_LIMIT:g}); first solve {first_s:.3f} s (bmg "
                  f"hierarchies {Timer.total('bdia.bmg_setup'):.3f} s{levels}), "
                  f"repeat {repeat_s:.3f} s = {1e3 * repeat_s / st2.iters:.3f}"
                  f" ms/iter ({st2.iters} iters); launches {counts} | "
                  f"{card_line()}")
        if precond == "auto":
            k4 = dict(launches=counts["K4"], iters=st2.iters,
                      repeat_s=repeat_s, first_s=first_s, err=err)
    return k4


def block_multi(H, A, device):
    """Phase 11: the lockstep k = 8 solve at full width (block-Jacobi
    through K5), then the HostCSR auto-route at m = 150.  Returns the K5
    launches of the k = 8 solve."""
    import torch
    import pysolvers_tpu_torch as pt
    from pysolvers_tpu_torch.utils.timing import Timer
    X_star = np.random.default_rng(1).random((H.shape[0], BLOCK_K))
    B = np.stack([H.matvec(X_star[:, j]) for j in range(BLOCK_K)], axis=1)
    reset_launches()
    t0 = time.perf_counter()
    st = pt.solve(A, B, tau=1e-10, maxiter=BLOCK_MAXITER, precond="bjacobi")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    X = st.soln.cpu().numpy()
    if X.shape != B.shape or not np.isfinite(X).all():
        raise SystemExit(f"multi-RHS solution has shape {X.shape} or is "
                         "not finite")
    resids = [host_residual(H, X[:, j], B[:, j]) for j in range(BLOCK_K)]
    errs = [float(np.linalg.norm(X[:, j] - X_star[:, j])
                  / np.linalg.norm(X_star[:, j])) for j in range(BLOCK_K)]
    if (not st.success or max(resids) > RESID_LIMIT
            or max(errs) > BLOCK_ERR_LIMIT or counts["K5"] <= 0
            or counts["K4"] != 0):
        raise SystemExit(f"multi-RHS block solve: success={st.success} "
                         f"resids={resids} errs={errs} launches={counts}")
    phase(11, f"solve(BdiaMatrix, B) k={BLOCK_K} bjacobi f64: iters="
              f"{st.iters} (max over columns) reason={st.reason.name} wall "
              f"{wall:.3f} s = {1e3 * wall / st.iters:.3f} ms/iter; host "
              f"rel resid per column max {max(resids):.3e} "
              f"{[f'{r:.2e}' for r in resids]}; err vs X* max {max(errs):.3e}; "
              f"launches {counts} | {card_line()}")
    native = dict(launches=counts["K5"], iters=st.iters, wall=wall,
                  err=max(errs))

    m = 150
    Hs = pt.fd_vector_laplacian_2d(m, b=BLOCK_B, coupling=BLOCK_COUPLING)
    x_star = np.random.default_rng(2).random(Hs.shape[0])
    b = Hs.matvec(x_star)
    Timer.reset()
    reset_launches()
    t0 = time.perf_counter()
    st = pt.solve(Hs, b, tau=1e-10, maxiter=BLOCK_MAXITER, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = launches()
    resid, err = check_solution("auto-route", Hs, b, x_star, st, device,
                                BLOCK_ERR_LIMIT)
    scalar = (Timer._counts.get("amg.host_hierarchy", 0)
              + Timer._counts.get("bdia.bmg_setup", 0))
    if c["K4"] <= 0 or c["K1"] != 0 or scalar:
        raise SystemExit(f"the auto-route did not take the block lane: "
                         f"launches {c}, SA hierarchies built {scalar}")
    phase(11, f"solve(HostCSR) fd_vector_laplacian_2d({m}, b={BLOCK_B}) "
              f"n={Hs.shape[0]}: auto-routed to the block lane (no SA "
              f"hierarchy, no K1) in {wall:.3f} s, iters={st.iters} reason="
              f"{st.reason.name} host rel resid={resid:.3e} err={err:.3e}; "
              f"launches {c}")
    return native


def lap2d_dia(m):
    """(5, n_pad) f64 DIA table and offsets of the 2-D FD Laplacian on an
    m x m interior grid, scale (m + 1)^2, assembled straight into diagonal
    storage as benchmarks/hbm_scale.py:41-59 does (a CSR at n = 1e8 costs
    ~20 GB of host index arrays)."""
    n = m * m
    s = (m + 1.0) ** 2
    diags = np.zeros((5, -(-n // 32) * 32))
    diags[2, :n] = 4.0 * s
    diags[1, :n] = -s              # west (off -1): absent at column 0
    diags[1, 0:n:m] = 0.0
    diags[3, :n] = -s              # east (off +1): absent at column m-1
    diags[3, m - 1:n:m] = 0.0
    diags[4, :n - m] = -s          # south (off +m)
    diags[0, m:n] = -s             # north (off -m)
    return diags, (-m, -1, 0, 1, m)


def lap2d_matvec(m, x):
    """The same operator applied matrix-free in f64 on the host
    (benchmarks/hbm_solve.py:68-85): the residual oracle, independent of
    the port."""
    g = x.reshape(m, m)
    y = 4.0 * g
    y[:, 1:] -= g[:, :-1]
    y[:, :-1] -= g[:, 1:]
    y[1:, :] -= g[:-1, :]
    y[:-1, :] -= g[1:, :]
    y *= (m + 1.0) ** 2
    return y.reshape(-1)


def check_k6_op(name, A, runs, flat=None):
    """K6 against its twin on the grid operator A (and K1 against its
    twin on ``flat``, the same operator in flat DIA form): error bound,
    CUDA-event times.  Returns K6's numbers."""
    import torch
    from pysolvers_tpu_torch.ops import grid_spmv, spmv
    dt = str(A.dtype).split(".")[1]
    tol = TOL[dt]
    D, n = len(A.pairs), A.n_rows
    nbytes = (D + 2) * n * A.diags.element_size()
    x = torch.as_tensor(np.random.default_rng(0).random(n), dtype=A.dtype,
                        device=A.device)
    y = grid_spmv.grid_dia_spmv(A, x)
    y_ref = grid_spmv.grid_dia_spmv_torch(A, x)
    torch.cuda.synchronize()
    abs_err = float((y - y_ref).abs().max())
    rel = abs_err / float(y_ref.abs().max())
    ok = bool(torch.isfinite(y).all()) and rel <= tol
    lib, lib_err, lib_line = None, None, ""
    if flat is not None:
        S = csr_of_dia(flat)
        lib, lib_err = try_library(lambda: S @ x)
        if lib is not None:
            library_agrees(y, lib(), tol, f"K6 {name} {dt}")
    del y, y_ref
    ms, plain_ms, lib_ms = time_pair(
        lambda: grid_spmv.grid_dia_spmv(A, x),
        lambda: grid_spmv.grid_dia_spmv_torch(A, x), lib, runs=runs)
    if flat is not None:
        lib_line = f" | {lib_text('CSR @ x', lib_ms, lib_err)}"
    bnd = bound(nbytes, 2 * D * n, dt)
    line = (f"K6 {name} {dt} grid {A.dims[0]}x{A.dims[1]} D={D} ldc={A.ldc} "
            f"rel_err={rel:.3e} (tol {tol:g}) K6 {ms:.4f} ms "
            f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s, bound "
            f"{bnd['bound_ms']:.4f} ms | twin {plain_ms:.4f} ms{lib_line}")
    if flat is not None:
        y1 = spmv.dia_spmv(flat, x)
        y1_ref = spmv.dia_spmv_torch(flat, x)
        torch.cuda.synchronize()
        rel1 = float((y1 - y1_ref).abs().max() / y1_ref.abs().max())
        if not (bool(torch.isfinite(y1).all()) and rel1 <= tol):
            raise SystemExit(f"K1 disagrees with its twin on {name} {dt}: "
                             f"rel {rel1:.3e} > {tol:g}")
        k6_k1 = float((y1 - grid_spmv.grid_dia_spmv(A, x)).abs().max()
                      / y1_ref.abs().max())
        del y1, y1_ref
        ms1, plain1, lib1 = time_pair(lambda: spmv.dia_spmv(flat, x),
                                      lambda: spmv.dia_spmv_torch(flat, x),
                                      lib, runs=runs)
        line += (f" || same operator flat: K1 {ms1:.4f} ms "
                 f"{nbytes / (ms1 * 1e-3) / 1e9:.1f} GB/s rel_err="
                 f"{rel1:.3e} | twin {plain1:.4f} ms"
                 f"{'' if lib is None else f' | CSR @ x {lib1:.4f} ms'}; "
                 f"K6 against K1 {k6_k1:.3e}")
        del S, lib
    phase(12, line)
    if not ok:
        raise SystemExit(f"K6 disagrees with its twin on {name} {dt}: rel "
                         f"{rel:.3e} > {tol:g}")
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, **bnd,
                **library_fields("torch.sparse_csr_tensor @ x", lib_ms,
                                 lib_err))


def check_k6(device, m=GRID_M):
    """Phase 12.  Assembles and uploads the full-width fine operator and
    returns {"A": it (flat DIA, f64), "assembly_s", "upload_s": the host
    seconds of both, "rec": K6's numbers on it in f64 for the kernels
    record}."""
    import torch
    from pysolvers_tpu_torch import convert
    from pysolvers_tpu_torch.linear.gmg_grid import _probe_coarse_dia
    from pysolvers_tpu_torch.ops.grid_spmv import GridDiaMatrix
    from pysolvers_tpu_torch.sparse.device import DiaMatrix
    card = card_line()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    diags, offsets = lap2d_dia(m)
    assembly_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    A = DiaMatrix.from_numpy(diags, offsets, (m * m, m * m), device=device)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    del diags
    G = GridDiaMatrix.from_dia_device(A, (m, m))
    phase(12, f"fine operator m={m} n={m * m} f64: host assembly "
              f"{assembly_s:.3f} s, upload {upload_s:.3f} s, flat table "
              f"{tuple(A.diags.shape)} and grid table "
              f"{tuple(G.diags.shape)} ({A.diags.numel() * 8 / 1e9:.2f} GB "
              f"each) | {card}")
    rec = check_k6_op(f"fine operator m={m}", G, 21, flat=A)
    A32 = DiaMatrix(A.diags.float(), A.offsets, A.offsets_dev, A.shape)
    G32 = GridDiaMatrix.from_dia_device(A32, (m, m))
    check_k6_op(f"fine operator m={m}", G32, 5, flat=A32)
    del A32, G32, G
    m_c = (m - 1) // 2
    t0 = time.perf_counter()
    Ac = _probe_coarse_dia(A, 2, m, m_c)
    torch.cuda.synchronize()
    probe_s = time.perf_counter() - t0
    Gc = GridDiaMatrix.from_dia_device(Ac, (m_c, m_c))
    phase(12, f"probed level m={m_c} (9-point) in {probe_s:.3f} s")
    check_k6_op(f"probed level m={m_c}", Gc, 5, flat=Ac)
    Ac32 = DiaMatrix(Ac.diags.float(), Ac.offsets, Ac.offsets_dev, Ac.shape)
    check_k6_op(f"probed level m={m_c}", GridDiaMatrix.from_dia_device(
        Ac32, (m_c, m_c)), 5, flat=Ac32)
    del Ac, Gc, Ac32
    rng = np.random.default_rng(5)
    pairs = tuple((dr, dc) for dr in range(-2, 3) for dc in range(-8, 9))
    R = rng.standard_normal((len(pairs), 1001, 777))
    for dt in (np.float64, np.float32):
        check_k6_op("random nonzero at the edges", convert.grid_dia_from_arrays(
            R.astype(dt), pairs, (1001, 777), device=device), 5)
    phase(12, f"all K6 checks passed; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB | {card}")
    return dict(A=A, assembly_s=assembly_s, upload_s=upload_s, rec=rec)


def profile_call(fn):
    """Device busy share of one call of fn and its top device ops: the
    durations of the CUDA events torch.profiler records (kernels, memcpy,
    memset; user ranges left out) over the call's wall time, summed by
    name from the raw trace (``key_averages`` takes ~0.3 ms per event,
    minutes on a level-scheduled solve's ~10^5 launches).  Returns (wall
    s, device s, rows of (us, name, count) in descending time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    agg = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != DeviceType.CUDA
                or getattr(e, "is_user_annotation", lambda: False)()):
            continue
        us, count = agg.get(e.name(), (0.0, 0))
        agg[e.name()] = (us + e.duration_ns() / 1e3, count + 1)
    rows = sorted(((us, name, count) for name, (us, count) in agg.items()),
                  reverse=True)
    dev_s = sum(r[0] for r in rows) / 1e6
    return wall, dev_s, rows


def grid_path(fine, device, m=GRID_M, num_levels=GRID_LEVELS):
    """Phase 13: benchmarks/hbm_solve.py's run_solve at native f64, from
    phase 12's fine operator (``fine``, whose flat table is taken out of
    it and dropped after setup).  Returns the launches of the first
    solve."""
    import torch
    from pysolvers_tpu_torch.core import StopReason
    from pysolvers_tpu_torch.linear.gmg_grid import (
        build_grid_hierarchy_device, grid_vc_apply)
    from pysolvers_tpu_torch.linear.krylov import cg_solve
    from pysolvers_tpu_torch.ops import matvec
    from pysolvers_tpu_torch.ops.grid_spmv import GridDiaMatrix
    from pysolvers_tpu_torch.utils.timing import Timer
    card = card_line()
    n = m * m
    t0 = time.perf_counter()
    x_star = np.random.default_rng(0).random(n)
    b = lap2d_matvec(m, x_star)
    b_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    Timer.reset()
    reset_launches()
    t0 = time.perf_counter()
    A = fine.pop("A")
    h = build_grid_hierarchy_device(A, num_levels, (m, m), smoother="jacobi")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    del A                       # the flat fine table (hbm_solve.py:128-129)
    A_f = h.levels[-1].A_dev
    vc2 = grid_vc_apply(2)
    t0 = time.perf_counter()
    b_dev = torch.as_tensor(b, device=device)
    torch.cuda.synchronize()
    b_up_s = time.perf_counter() - t0

    def solve():
        return cg_solve(lambda v: matvec(A_f, v), b_dev, maxiter=200,
                        tau=1e-10, precond=lambda r: vc2(h, r))

    t0 = time.perf_counter()
    x, st, _ = solve()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = launches()
    probes = {k: v for k, v in Timer._totals.items()
              if k.startswith("gmg.probe")}
    levels = [(h.ms[0], "dense inverse", h.ms[0] ** 2)] + [
        (mk, type(L.A_dev).__name__, len(L.A_dev.pairs)
         if isinstance(L.A_dev, GridDiaMatrix) else len(L.A_dev.offsets))
        for mk, L in zip(h.ms[1:], h.levels[1:])]
    phase(13, f"Lap2D(m={m}) n={n} f64, PCG + GMG{num_levels} (grid, "
              f"jacobi, 2 V-cycles): host assembly {fine['assembly_s']:.3f} "
              f"s, upload {fine['upload_s']:.3f} s, x* and b on the host "
              f"{b_s:.3f} s, "
              f"b upload {b_up_s:.3f} s; hierarchy {setup_s:.3f} s = probes "
              f"{ {k[10:]: round(v, 4) for k, v in probes.items()} } + grid "
              f"conversion {Timer.total('gmg.grid_convert'):.4f} s + "
              f"coarsest inverse {Timer.total('gmg.coarse_inverse'):.4f} s")
    phase(13, f"levels (m, format, D; the coarsest: its order), coarsest "
              f"first: {levels}")
    if not isinstance(A_f, GridDiaMatrix):
        raise SystemExit("the fine level is not a GridDiaMatrix")
    xh = x.cpu().numpy()
    if xh.shape != (n,) or not np.isfinite(xh).all():
        raise SystemExit(f"grid path: solution has shape {xh.shape} or is "
                         "not finite")
    resid = float(np.linalg.norm(b - lap2d_matvec(m, xh)) / np.linalg.norm(b))
    err = float(np.linalg.norm(xh - x_star) / np.linalg.norm(x_star))
    del xh, x
    reason = StopReason(st.reason).name
    if (reason != "CONVERGED" or resid > RESID_LIMIT or err > GRID_ERR_LIMIT
            or counts["K6"] <= 0 or counts["K1"] <= 0):
        raise SystemExit(f"grid path: reason={reason} resid={resid:.3e} "
                         f"err={err:.3e} launches={counts}")
    t0 = time.perf_counter()
    _, st2, _ = solve()
    torch.cuda.synchronize()
    repeat_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    phase(13, f"iters={st.k} reason=CONVERGED host rel resid={resid:.3e} "
              f"(matrix-free f64 stencil) err vs x*={err:.3e} (limit "
              f"{GRID_ERR_LIMIT:g}); first solve {first_s:.3f} s, repeat "
              f"{repeat_s:.3f} s = {1e3 * repeat_s / st2.k:.3f} ms/iter "
              f"({st2.k} iters); launches {counts}; peak device memory "
              f"{peak:.2f} GB (setup and solves) | {card}")
    wall, dev_s, rows = profile_call(solve)
    if rows:
        top = "; ".join(f"{k[:60]} {us / 1e3:.3f} ms x{c}"
                        for us, k, c in rows[:8])
        phase(13, f"profiled repeat solve: wall {wall:.3f} s, device "
                  f"{dev_s:.3f} s, busy {100 * dev_s / wall:.1f} %; top "
                  f"device ops: {top}")
    else:
        phase(13, "profiled repeat solve: the profiler saw no device time "
                  "(busy share not measured)")
    return dict(counts=counts, b=b, x_star=x_star, iters=st.k,
                first_s=first_s, repeat_s=repeat_s, peak=peak, err=err,
                peak_above=peak - base / 1e9,
                setup_s=setup_s, busy=(100 * dev_s / wall if rows else None))


def profile_unstructured(path, fine32, rec):
    """Phase 15, last because a profiler session can leave host overhead
    on every later launch: the phase-7 re-solve under torch.profiler
    (busy share, K2's share and launches per iteration), then the device
    time alone of K2, K3 and the CSR call on the fine operator, f64 and
    f32.  Adds the f64 device times to K2's and K3's records."""
    import torch
    from pysolvers_tpu_torch.ops import bws_spmv
    Ap, A_bws, solver, b = (path[k] for k in ("Ap", "A_bws", "solver", "b"))
    wall, dev_s, rows = profile_call(lambda: solver.solve((Ap, A_bws), b))
    if not rows:
        phase(15, "profiled re-solve: the profiler saw no device time (busy "
                  "share not measured)")
        return
    k2_us = sum(us for us, k, _ in rows if "bws_spmv" in k)
    k2_n = sum(c for _, k, c in rows if "bws_spmv" in k)
    top = "; ".join(f"{k[:60]} {us / 1e3:.3f} ms x{c}"
                    for us, k, c in rows[:6])
    iters, solve_s = path["iters"], path["solve_s"]
    phase(15, f"profiled unstructured re-solve: wall {1e3 * wall:.3f} ms, "
              f"device {1e3 * dev_s:.3f} ms, busy {100 * dev_s / wall:.1f} % "
              f"(of phase 7's median {1e3 * solve_s:.3f} ms: "
              f"{100 * dev_s / solve_s:.1f} %); K2 {k2_us / 1e3:.3f} ms = "
              f"{100 * k2_us / 1e6 / dev_s:.1f} % of device time, "
              f"{k2_n / iters:.1f} K2 launches and "
              f"{sum(r[2] for r in rows) / iters:.1f} device ops per "
              f"iteration ({iters} iters); top device ops: {top}")
    for A in (A_bws, fine32):
        x = torch.as_tensor(np.random.default_rng(0).standard_normal(
            A.n_cols), dtype=A.dtype, device=A.device)
        S = csr_of_host(Ap, A.dtype, A.device)
        times = {name: device_ms(fn) for name, fn in (
            ("K2", lambda: bws_spmv.bws_spmv(A, x)),
            ("K3", lambda: bws_spmv.bws_spmv_by_class(A, x)),
            ("CSR @ x", lambda: S @ x))}
        dt = str(A.dtype).split(".")[1]
        phase(15, f"device time alone per call (profiler, 20 calls), fine "
                  f"operator {dt}: " + ", ".join(
                      f"{k} {v} ms" for k, v in times.items()))
        if A is A_bws:
            for k in ("K2", "K3"):
                rec[k].update(device_ms=times[k],
                              library_device_ms=times["CSR @ x"])
        del S, x


def oo_gmg(device, m=OO_GMG_M, num_levels=OO_GMG_LEVELS):
    """Phase 14: the factory forms of GMG at run_large.py's m = 1023."""
    import torch
    import pysolvers_tpu_torch as pt
    H = pt.problems.fd_laplacian_2d(m)
    x_star = np.random.default_rng(6).random(H.shape[0])
    b = H.matvec(x_star)
    runs = [(f"PCG + GMGPreconditionerType(galerkin={gal!r})",
             pt.PCG(pt.CommonSolverArgs(maxiter=200, tau=1e-10),
                    precond=pt.GMGPreconditionerType(
                        (m, m), num_iters=2, num_levels=num_levels,
                        smoother="jacobi", galerkin=gal),
                    device=device)) for gal in ("host", "device")]
    runs.append(("GMGVCycle(matrix_format='grid')", pt.GMGVCycle(
        pt.CommonSolverArgs(maxiter=100, tau=1e-10), dims=(m, m),
        num_levels=num_levels, matrix_format="grid", device=device)))
    for name, typ in runs:
        solver = typ.make_solver()
        reset_launches()
        t0 = time.perf_counter()
        st = solver.solve(H, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()
        resid, err = check_solution(name, H, b, x_star, st, device)
        if counts["K1"] <= 0 or counts["K6"] != 0:
            raise SystemExit(f"{name}: launches {counts}")
        solver.freeze_matrix()
        solver.freeze_prec()
        t0 = time.perf_counter()
        st2 = solver.solve(H, b)
        torch.cuda.synchronize()
        repeat_s = time.perf_counter() - t0
        phase(14, f"{name} fd_laplacian_2d({m}) f64 {num_levels} levels: "
                  f"iters={st.iters} reason={st.reason.name} host rel "
                  f"resid={resid:.3e} err={err:.3e}; first call {wall:.3f} "
                  f"s (setup included), frozen repeat {repeat_s:.3f} s "
                  f"({st2.iters} iters); launches {counts} | {card_line()}")


def check_converged(tag, H, b, x_star, st, device, err_limit=1e-6):
    """check_solution, and the stop reason must be CONVERGED."""
    if st.reason.name != "CONVERGED":
        raise SystemExit(f"{tag}: stopped {st.reason.name} after {st.iters} "
                         "iterations")
    return check_solution(tag, H, b, x_star, st, device, err_limit)


def near(tag, iters, ref):
    """The iteration count within ITERS_SLACK of the reference's."""
    if abs(iters - ref) > ITERS_SLACK * ref:
        raise SystemExit(f"{tag}: {iters} iterations, the JAX package's "
                         f"{ref} (allowed {100 * ITERS_SLACK:g} %)")


def wall_ms(fn, calls=5):
    """Wall milliseconds per call of fn, synchronized (one untimed call
    first): for host-bound calls such as the level-scheduled solves."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / calls


def peak_reset():
    """Reset the peak-memory counter; returns the bytes allocated now."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def peak_above(base):
    """GB of the peak allocation since ``peak_reset`` above its base."""
    import torch
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def block_shape(plan):
    """(blocks, block size, block reach) of a BlockTriSolvePlan."""
    return plan.nb, plan.bs, plan.p


def block_bytes(plans):
    """The bytes block solves with ``plans`` must move at least: each
    plan's s_hat and dinv, and three vectors (b read, x written and read
    back by the next factor)."""
    size = plans[0].dinv.element_size()
    return (sum((p.s_hat.numel() + p.dinv.numel()) * size for p in plans)
            + 3 * plans[0].n * size)


def factor_bytes(factors, size):
    """The bytes the same triangular solves need at least when read from
    the factors themselves (CSR: each value, its int32 column index and
    the int32 row pointers) rather than from the plans' dense blocks, with
    the same vectors as ``block_bytes`` (two for one factor)."""
    n = factors[0].shape[0]
    return (sum(T.nnz * (size + 4) + 4 * (n + 1) for T in factors)
            + (len(factors) + 1) * n * size)


@contextlib.contextmanager
def no_degrade():
    """The block path's degrade warnings raise (phases 16, 17, 20, 25)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=DEGRADE)
        yield


def capped_ms_per_iter(H, b, mode, device):
    """ms per iteration of phase 16's solve capped at PROFILE_MAXITER
    iterations, ILUT applied in ``mode``, the preconditioner formed
    beforehand (frozen)."""
    import torch
    import pysolvers_tpu_torch as pt
    solver = pt.GMRES(pt.CommonSolverArgs(maxiter=PROFILE_MAXITER, tau=1e-10,
                                          failOnMaxiter=False),
                      precond=pt.ILUTPreconditionerType(trisolve_mode=mode),
                      device=device).make_solver()
    solver.freeze_matrix()
    solver.freeze_prec()
    solver.solve(H, b)                   # forms the factors and the plans
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = solver.solve(H, b)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / st.iters


def gmres_ilut(device):
    """Phase 16: solve() with every argument but tau at its default on the
    nonsymmetric convection-diffusion operator: full GMRES preconditioned by
    ILUT with block solves ("auto" on the card, K8), K1 for the operator;
    then ms per apply and per iteration (capped at PROFILE_MAXITER) in
    block and in explicit "level" mode.  Returns the problem and the
    numbers the kernels line, phase 26 and the profile need."""
    import torch
    import pysolvers_tpu_torch as pt
    card = card_line()
    H = pt.fd_convection_diffusion_2d(CD_M)
    n = H.shape[0]
    x_star = np.random.default_rng(2).random(n)
    b = H.matvec(x_star)
    base = peak_reset()
    reset_launches()
    t0 = time.perf_counter()
    with no_degrade():
        st = pt.solve(H, b, tau=1e-10)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    k8 = by_dtype(("K8",))
    peak = peak_above(base)
    resid, err = check_converged("phase 16", H, b, x_star, st, device)
    near("phase 16", st.iters, CD_ITERS)
    # one product per iteration, one at the start, one true residual; one
    # K8 launch per factor, one apply per iteration and one to form x
    if counts["K1"] != st.iters + 2 or counts["K8"] != 2 * (st.iters + 1):
        raise SystemExit(f"phase 16: launches {counts}, {st.iters} iters")
    # the same preconditioner formed alone: its setup, plans and applies
    ilut = pt.ILUTPreconditionerType()
    t0 = time.perf_counter()
    L, U = ilut._factor(H, device)
    factor_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with no_degrade():
        prec = ilut.form(H, device=device)
    torch.cuda.synchronize()
    form_s = time.perf_counter() - t0
    plans = prec.state
    v = torch.as_tensor(np.random.default_rng(0).standard_normal(n),
                        device=device)
    apply_ms = wall_ms(lambda: prec.apply_any(v), calls=20)
    level = pt.ILUTPreconditionerType(trisolve_mode="level").form(
        H, device=device)
    level_ms = wall_ms(lambda: level.apply_any(v))
    nbytes = block_bytes(plans)
    bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    fbytes = factor_bytes((L, U), plans[0].dinv.element_size())
    factor_bound_ms = 1e3 * fbytes / HBM_BYTES_PER_S
    capped = {mode: capped_ms_per_iter(H, b, mode, device)
              for mode in ("block", "level")}
    phase(16, f"solve(fd_convection_diffusion_2d({CD_M}), b, tau=1e-10) "
              f"n={n}, defaults (GMRES + ILUT, block solves): iters="
              f"{st.iters} (JAX {CD_ITERS}) reason={st.reason.name} host rel "
              f"resid={resid:.3e} err vs x*={err:.3e}; wall {wall:.3f} s = "
              f"{1e3 * wall / st.iters:.3f} ms/iter (setup included: ILUT "
              f"factor {factor_s:.3f} s, form with plans {form_s:.3f} s); "
              f"solution on {st.soln.device}; launches {counts} (K8 by "
              f"dtype {k8}); peak device memory {peak:.3f} GB above "
              f"the phase's start | {card}")
    phase(16, f"ILUT factors: L nnz={L.nnz} (n={n}), U nnz={U.nnz}; block "
              f"plans (blocks, bs, reach): L {block_shape(plans[0])}, U "
              f"{block_shape(plans[1])}; one ILUT apply {apply_ms:.3f} ms "
              f"wall, bound {bound_ms:.4f} ms ({nbytes} plan bytes at 3.35 "
              f"TB/s; {100 * bound_ms / apply_ms:.2f} %), factor bound "
              f"{factor_bound_ms:.4f} ms ({fbytes} factor bytes; "
              f"{100 * factor_bound_ms / apply_ms:.2f} %) | level solves of the same factors {level_ms:.3f} ms; capped "
              f"at {PROFILE_MAXITER} iterations: block "
              f"{capped['block']:.3f} ms/iter, level {capped['level']:.3f} "
              f"ms/iter | {card_line()}")
    return dict(H=H, b=b, x_star=x_star, iters=st.iters, K1=counts["K1"],
                K8=k8, apply_ms=apply_ms, level_ms=level_ms, L=L, U=U,
                wall=wall, capped=capped)


def gmres_jacobi_bws(p16, device):
    """Phase 16b: the same system by FGMRES with ILUT applied by Jacobi
    sweeps whose products run on the strict factors packed as BWS (K2).
    Flexible: the f32 sweeps make the apply inexact at ~1e-7, which
    non-flexible GMRES (x = M(Q y)) reports as TRUE_RESID_MISMATCH at tau
    = 1e-10.  Returns the K1 and K2 launches."""
    import torch
    import pysolvers_tpu_torch as pt
    from pysolvers_tpu_torch.linear import ilu
    H, b, x_star = (p16[k] for k in ("H", "b", "x_star"))
    n = H.shape[0]
    # the sweeps factor once at the seed scale (no fill-budget search)
    L, U = ilu.ilut_factor(H, 1e-3 * ilu._AUTO_SEED, 15.0)
    prec = pt.ILUTPreconditionerType(trisolve_mode="jacobi_bws")
    solver = pt.GMRES(pt.CommonSolverArgs(maxiter=1000, tau=1e-10),
                      precond=prec, flexible=True, device=device).make_solver()
    base = peak_reset()
    reset_launches()
    t0 = time.perf_counter()
    st = solver.solve(H, b)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    peak = peak_above(base)
    resid, err = check_converged("phase 16b", H, b, x_star, st, device)
    # sweeps - 1 products per factor with off-diagonal entries, one apply
    # per iteration (FGMRES forms x from Z)
    per_apply = (prec.sweeps - 1) * (int(L.nnz > n) + int(U.nnz > n))
    if (counts["K2"] != per_apply * st.iters
            or counts["K1"] != st.iters + 2):
        raise SystemExit(f"phase 16b: launches {counts}, {st.iters} iters, "
                         f"{per_apply} sweep products per apply")
    v = torch.as_tensor(np.random.default_rng(0).standard_normal(n),
                        device=device)
    apply_ms = wall_ms(lambda: solver._formed_prec.apply_any(v))
    phase("16b", f"FGMRES + ILUT(trisolve_mode='jacobi_bws', sweeps="
                 f"{prec.sweeps}) same system: iters={st.iters} reason="
                 f"{st.reason.name} host rel resid={resid:.3e} err vs x*="
                 f"{err:.3e}; wall {wall:.3f} s = {1e3 * wall / st.iters:.3f} "
                 f"ms/iter; one apply {apply_ms:.3f} ms wall; K2 launches "
                 f"{counts['K2']} = {per_apply} sweep products x {st.iters} "
                 f"applies; launches {counts}; solution on {st.soln.device}; "
                 f"peak device memory {peak:.3f} GB above the phase's start "
                 f"| {card_line()}")
    return dict(K1=counts["K1"], K2=counts["K2"])


def pcg_ic(device):
    """Phase 17: solve() with its defaults on fd_laplacian_2d(129) (SPD,
    n < 20,000): PCG + IC(t) with block solves (K8), K1.  Returns the
    launches, the factor for phase 26 and the block and level applies for
    phase 15."""
    import torch
    import pysolvers_tpu_torch as pt
    H = pt.problems.fd_laplacian_2d(IC_M)
    n = H.shape[0]
    x_star = np.random.default_rng(2).random(n)
    b = H.matvec(x_star)
    reset_launches()
    t0 = time.perf_counter()
    with no_degrade():
        st = pt.solve(H, b, tau=1e-10)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    k8 = by_dtype(("K8",))
    resid, err = check_converged("phase 17", H, b, x_star, st, device)
    near("phase 17", st.iters, IC_ITERS)
    # one apply at the start and one per iteration, two K8 launches each
    if counts["K1"] != st.iters + 1 or counts["K8"] != 2 * (st.iters + 1):
        raise SystemExit(f"phase 17: launches {counts}, {st.iters} iters")
    ic = pt.ICPreconditionerType()
    Lc = ic._factor(H, device)
    with no_degrade():
        prec = ic.form(H, device=device)
    v = torch.as_tensor(np.random.default_rng(0).standard_normal(n),
                        device=device)
    apply_ms = wall_ms(lambda: prec.apply_any(v), calls=20)
    level = pt.ICPreconditionerType(trisolve_mode="level").form(
        H, device=device)
    level_ms = wall_ms(lambda: level.apply_any(v))
    plans = prec.state
    phase(17, f"solve(fd_laplacian_2d({IC_M}), b, tau=1e-10) n={n}, "
              f"defaults (PCG + IC(t), block solves): iters={st.iters} (JAX "
              f"{IC_ITERS}) reason={st.reason.name} host rel resid="
              f"{resid:.3e} err vs x*={err:.3e}; wall {wall:.3f} s = "
              f"{1e3 * wall / st.iters:.3f} ms/iter (setup included); IC "
              f"factor nnz={Lc.nnz} ({Lc.nnz / n:.2f} per row), block plans "
              f"L {block_shape(plans[0])} Lt {block_shape(plans[1])}, one "
              f"apply {apply_ms:.3f} ms wall (level solves {level_ms:.3f} "
              f"ms), bound "
              f"{1e3 * block_bytes(plans) / HBM_BYTES_PER_S:.4f} ms (plan "
              f"bytes), factor bound "
              f"{1e3 * factor_bytes((Lc, Lc), 8) / HBM_BYTES_PER_S:.4f} ms; "
              f"launches {counts} (K8 by dtype {k8}); solution on "
              f"{st.soln.device} | {card_line()}")
    return dict(K1=counts["K1"], K8=k8, Lc=Lc, apply_ms=apply_ms,
                level_ms=level_ms, block=prec, level=level, v=v)


def k8_geometry_text(plan):
    """K8's launch geometry for ``plan`` as phase 26 prints it."""
    from pysolvers_tpu_torch.ops import block_trisolve as bt
    geo = bt.k8_launch_geometry(plan)
    if geo is None:
        return "stage 1 alone (p = 0)", None
    return (f"cluster {geo.cluster} CTAs x {geo.rows} rows, {geo.stages} "
            f"stages of {geo.chunk_bytes} B ({geo.chunks} chunk(s) a step, "
            f"{'bulk copies' if geo.bulk else 'cp.async per value'}), "
            f"{geo.vec} row(s) of x a message, {geo.smem_bytes} B shared a "
            f"CTA"), geo


def check_k8(p16, p17, device):
    """Phase 26: K8 against its twin on phase 16's ILUT factors and phase
    17's IC factor and its transpose, f32 and f64: the error, the launch
    geometry, CUDA-event times of K8, its twin and the library call
    (``torch.triangular_solve`` with the factor as a CUDA sparse CSR
    tensor, which runs cuSPARSE's SpSV, in turns with K8), the bytes
    bounds and the level-scheduled solve of the same factor.  Returns the
    kernels-record numbers at phase 16's U in f64, the path's widest
    solve."""
    import torch
    from pysolvers_tpu_torch.ops import block_trisolve as bt
    from pysolvers_tpu_torch.ops import trisolve as lt
    card = card_line()
    rng = np.random.default_rng(4)
    Lc = p17["Lc"]
    record = None
    lib_name = "torch.triangular_solve (sparse CSR: cuSPARSE SpSV)"
    for name, T, lower, unit in (
            ("phase 16 ILUT L", p16["L"], True, True),
            ("phase 16 ILUT U", p16["U"], False, False),
            ("phase 17 IC L", Lc, True, False),
            ("phase 17 IC Lt", Lc.transpose(), False, False)):
        bh = rng.standard_normal(T.shape[0])
        for dts in ("float32", "float64"):
            plan = bt.build_block_trisolve_plan(T, lower, unit, dtype=dts,
                                                device=device)
            geo_text, geo = k8_geometry_text(plan)
            b = torch.as_tensor(bh, dtype=plan.dtype, device=device)
            x = bt.block_trisolve(plan, b)
            ref = bt.block_trisolve_torch(plan, b)
            torch.cuda.synchronize()
            abs_err = float((x - ref).abs().max())
            rel = abs_err / float(ref.abs().max())
            ok = bool(torch.isfinite(x).all()) and rel <= K8_TOL[dts]
            T_csr = csr_of_host(T, plan.dtype, device)
            b2 = b[:, None].contiguous()
            lib, lib_err = try_library(lambda: torch.triangular_solve(
                b2, T_csr, upper=not lower, unitriangular=unit))
            if lib is not None:
                library_agrees(x, lib().solution[:, 0], K8_TOL[dts],
                               f"K8 on {name} {dts}")
            ms, plain_ms, lib_ms = time_pair(
                lambda: bt.block_trisolve(plan, b),
                lambda: bt.block_trisolve_torch(plan, b), library=lib,
                runs=7, calls=5)
            lp = lt.build_trisolve_plan(T, lower, unit, dtype=dts,
                                        device=device)
            level_ms = wall_ms(lambda: lt.trisolve(lp, b), calls=3)
            size = plan.dinv.element_size()
            nbytes = ((plan.s_hat.numel() + plan.dinv.numel()) * size
                      + 2 * plan.n * size)
            bnd = bound(nbytes, 2 * plan.nb * plan.bs * (plan.p + 1)
                        * plan.bs, dts)
            # what stage 1 reads of dinv: its lower triangles
            tri = plan.nb * plan.bs * (plan.bs + 1) // 2
            tbytes = (plan.s_hat.numel() + tri) * size + 2 * plan.n * size
            tbnd = bound(tbytes, 2 * (plan.s_hat.numel() + tri), dts)
            # what the solve itself needs: the factor's nonzeros, not the
            # plan's dense blocks
            fbnd = bound(factor_bytes((T,), size), 2 * T.nnz, dts)
            phase(26, f"K8 {name} {dts} n={plan.n} nnz={T.nnz} (blocks, "
                      f"bs, reach) {block_shape(plan)} rel_err={rel:.3e} "
                      f"(tol {K8_TOL[dts]:g}) K8 {ms:.4f} ms "
                      f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s, {geo_text}; "
                      f"bound {bnd['bound_ms']:.4f} ms by the plan's "
                      f"{nbytes} bytes ({100 * bnd['bound_ms'] / ms:.2f} %), "
                      f"{tbnd['bound_ms']:.4f} ms by its {tbytes} bytes "
                      f"with dinv's lower triangles "
                      f"({100 * tbnd['bound_ms'] / ms:.2f} %), "
                      f"{fbnd['bound_ms']:.4f} ms by the factor's "
                      f"({100 * fbnd['bound_ms'] / ms:.3f} %) | twin "
                      f"{plain_ms:.4f} ms | "
                      f"{lib_text(lib_name, lib_ms, lib_err)} | "
                      f"level-scheduled solve {level_ms:.4f} ms wall | {card}")
            if not ok:
                raise SystemExit(f"K8 disagrees with its twin on {name} "
                                 f"{dts}: rel {rel:.3e} > {K8_TOL[dts]:g}")
            if name == "phase 16 ILUT U" and dts == "float64":
                # bound_ms: what the function needs (the factor's CSR);
                # the bounds of the plan's dense blocks and of their lower
                # triangles stand beside it
                record = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                              level_ms=level_ms, **fbnd,
                              plan_bound_ms=bnd["bound_ms"],
                              triangle_bound_ms=tbnd["bound_ms"],
                              cluster=geo.cluster, stages=geo.stages,
                              **library_fields(lib_name, lib_ms, lib_err))
            del plan, lp, x, ref, T_csr, lib
    return record


def gmres_amg(device, pcg_ms, m=1023):
    """Phase 18: GMRES preconditioned by SA-AMG on phase 4's operator and
    right-hand side, with MGS and CGS2 (Q allocated (501, n) as in the JAX
    package).  Returns the K1 launches of each first solve."""
    import torch
    import pysolvers_tpu_torch as pt
    H = pt.problems.fd_laplacian_2d(m)
    x_star = np.random.default_rng(2).random(H.shape[0])
    b = H.matvec(x_star)
    out = {}
    for orthog in ("mgs", "cgs2"):
        solver = pt.GMRES(pt.CommonSolverArgs(maxiter=500, tau=1e-10),
                          precond=pt.AMGPreconditionerType(num_iters=2,
                                                           num_levels=6),
                          orthog=orthog, device=device).make_solver()
        base = peak_reset()
        reset_launches()
        t0 = time.perf_counter()
        st = solver.solve(H, b)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = launches()
        resid, err = check_converged(f"phase 18 {orthog}", H, b, x_star, st,
                                     device)
        if st.iters > GMRES_AMG_MAX_ITERS or counts["K1"] <= 0:
            raise SystemExit(f"phase 18 {orthog}: {st.iters} iterations "
                             f"(at most {GMRES_AMG_MAX_ITERS}), launches "
                             f"{counts}")
        solver.freeze_matrix()
        solver.freeze_prec()
        walls = []                  # the median of five frozen repeats
        for _ in range(5):
            t0 = time.perf_counter()
            st2 = solver.solve(H, b)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        repeat_s = statistics.median(walls)
        peak = peak_above(base)
        phase(18, f"GMRES(maxiter=500, orthog={orthog!r}) + AMG(num_iters=2,"
                  f" num_levels=6) fd_laplacian_2d({m}) n={H.shape[0]} f64: "
                  f"iters={st.iters} (JAX 9) reason={st.reason.name} host rel "
                  f"resid={resid:.3e} err vs x*={err:.3e}; first call "
                  f"{first_s:.3f} s (AMG setup included), frozen repeat "
                  f"{repeat_s:.6f} s, the median of "
                  f"{[round(w, 6) for w in walls]}, = "
                  f"{1e3 * repeat_s / st2.iters:.3f} ms/iter"
                  f" (phase 4's PCG: {pcg_ms:.3f} ms/iter); launches {counts};"
                  f" solution on {st.soln.device}; peak device memory "
                  f"{peak:.3f} GB above the phase's start | {card_line()}")
        out[orthog] = dict(K1=counts["K1"], repeat_s=repeat_s,
                           iters=st2.iters)
    return out


def direct(device):
    """Phase 19: solve() on an n <= 500 system takes the dense direct solve
    on the card; DefaultDirect on a DiaMatrix on the card; both against
    scipy's sparse LU."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    import torch
    import pysolvers_tpu_torch as pt
    H = pt.problems.fd_laplacian_2d(DIRECT_M)
    x_star = np.random.default_rng(2).random(H.shape[0])
    b = H.matvec(x_star)
    x_ref = spla.spsolve(sp.csc_matrix(sp.csr_matrix(
        (H.data, H.indices, H.indptr), shape=H.shape)), b)
    for tag, A, call in (
            ("solve(HostCSR)", H, lambda A: pt.solve(A, b)),
            ("DefaultDirect(DiaMatrix)",
             pt.DiaMatrix.from_host_csr(H, device=device),
             lambda A: pt.DefaultDirect().make_solver().solve(A, b))):
        reset_launches()
        t0 = time.perf_counter()
        st = call(A)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()
        resid, err = check_converged(f"phase 19 {tag}", H, b, x_star, st,
                                     device)
        rel = float(np.linalg.norm(st.soln.cpu().numpy() - x_ref)
                    / np.linalg.norm(x_ref))
        if st.iters != 1 or rel > DIRECT_ERR_LIMIT:
            raise SystemExit(f"phase 19 {tag}: iters={st.iters}, rel err "
                             f"against spsolve {rel:.3e}")
        phase(19, f"{tag} fd_laplacian_2d({DIRECT_M}) n={H.shape[0]}: "
                  f"direct (iters=1) in {1e3 * wall:.3f} ms; rel err against "
                  f"scipy spsolve {rel:.3e} (limit {DIRECT_ERR_LIMIT:g}), "
                  f"host rel resid={resid:.3e}; launches {counts}; solution "
                  f"on {st.soln.device} | {card_line()}")


def block_gmres_ic(device, m=BLOCK_GMRES_M):
    """Phase 20: the block lane's GMRES (K4 for the operator, block-Jacobi
    on the right) and its CG with the scalar IC(t) of the host CSR view
    (factored in f32, its block plans in f64: K8 f64).  Returns the K4 launches of the GMRES solve and
    the K8 launches by dtype of the IC solve."""
    import torch
    import pysolvers_tpu_torch as pt
    H = pt.fd_vector_laplacian_2d(m, b=BLOCK_B, coupling=BLOCK_COUPLING)
    x_star = np.random.default_rng(2).random(H.shape[0])
    b = H.matvec(x_star)
    A = pt.BdiaMatrix.from_host_csr(H, BLOCK_B, device=device)
    out = {}
    for method, precond, ref in (("gmres", "auto", BLOCK_GMRES_ITERS),
                                 ("auto", "ic", BLOCK_IC_ITERS)):
        base = peak_reset()
        reset_launches()
        t0 = time.perf_counter()
        with no_degrade():
            st = pt.solve(A, b, tau=1e-10, method=method, precond=precond)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()
        k8 = by_dtype(("K8",))
        peak = peak_above(base)
        tag = f"phase 20 method={method} precond={precond}"
        resid, err = check_converged(tag, H, b, x_star, st, device,
                                     BLOCK_ERR_LIMIT)
        near(tag, st.iters, ref)
        # GMRES: one product per iteration, one at the start, one true
        # residual; CG: one per iteration and one at the start
        if counts["K4"] != st.iters + (2 if method == "gmres" else 1):
            raise SystemExit(f"{tag}: launches {counts}, {st.iters} iters")
        # the IC: one apply at the start and one per iteration, two f64
        # K8 launches each
        if precond == "ic" and k8["K8 f64"] != 2 * (st.iters + 1):
            raise SystemExit(f"{tag}: K8 launches {k8}, {st.iters} iters")
        phase(20, f"solve(BdiaMatrix fd_vector_laplacian_2d({m}, b="
                  f"{BLOCK_B}), b, tau=1e-10, method={method!r}, precond="
                  f"{precond!r}) n={H.shape[0]}: iters={st.iters} (JAX {ref})"
                  f" reason={st.reason.name} host rel resid={resid:.3e} err "
                  f"vs x*={err:.3e}; wall {wall:.3f} s = "
                  f"{1e3 * wall / st.iters:.3f} ms/iter (setup included); "
                  f"launches {counts} (K8 by dtype {k8}); solution on "
                  f"{st.soln.device}; peak device memory {peak:.3f} GB "
                  f"above the phase's start | {card_line()}")
        out[method] = counts["K4"], k8
    return out["gmres"][0], out["auto"][1]


def profile_gmres_ilut(p16, device):
    """Phase 15, second part: phase 16's solve capped at PROFILE_MAXITER
    iterations (preconditioner formed beforehand: block plans, K8) under
    torch.profiler: busy share, device ops per iteration, and the shares
    of K1, of K8 (its two stages), of MGS (the dot and addcmul kernels
    only it launches) and of the ILUT applies (the same applies profiled
    alone)."""
    import torch
    import pysolvers_tpu_torch as pt
    H, b = p16["H"], p16["b"]
    solver = pt.GMRES(pt.CommonSolverArgs(maxiter=PROFILE_MAXITER, tau=1e-10,
                                          failOnMaxiter=False),
                      precond=pt.ILUTPreconditionerType(),
                      device=device).make_solver()
    solver.freeze_matrix()
    solver.freeze_prec()
    solver.solve(H, b)                   # forms the factors and the plans
    walls = []                           # the median of three, unprofiled
    for _ in range(3):
        t0 = time.perf_counter()
        solver.solve(H, b)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    solve_ms = 1e3 * statistics.median(walls)
    wall, dev_s, rows = profile_call(lambda: solver.solve(H, b))
    if not rows:
        phase(15, "profiled GMRES + ILUT: the profiler saw no device time "
                  "(shares not measured)")
        return
    iters = PROFILE_MAXITER
    applies = iters + 1                  # one per iteration, one to form x
    prec = solver._formed_prec
    v = torch.as_tensor(b, device=device)
    apply_wall, apply_dev_s, apply_rows = profile_call(
        lambda: [prec.apply_any(v) for _ in range(applies)])
    k1_us = sum(us for us, k, _ in rows if "dia_spmv" in k)
    k8 = ("diag_block_kernel", "recurrence_kernel")
    k8_us = sum(us for us, k, _ in rows if any(t in k for t in k8))
    mgs = ("dot_kernel", "reduce_1Block", "addcmul")
    mgs_us = sum(us for us, k, _ in rows if any(t in k for t in mgs))
    ops = sum(c for _, _, c in rows)
    top = "; ".join(f"{k[:60]} {us / 1e3:.3f} ms x{c}"
                    for us, k, c in rows[:6])
    # busy share over the unprofiled wall: the profiler's host cost per
    # launch (thousands per iteration here) inflates the profiled one
    phase(15, f"profiled GMRES + ILUT (phase 16's system, {iters} "
              f"iterations): unprofiled wall {solve_ms:.3f} ms, the median "
              f"of {[round(1e3 * w, 3) for w in walls]}; device "
              f"{1e3 * dev_s:.3f} ms, busy {100e3 * dev_s / solve_ms:.1f} % "
              f"of the unprofiled wall ({100 * dev_s / wall:.1f} % of the "
              f"profiled wall {1e3 * wall:.3f} ms); {ops / iters:.1f} device "
              f"ops per "
              f"iteration; K1 {k1_us / 1e3:.3f} ms = "
              f"{100 * k1_us / 1e6 / dev_s:.1f} % of device time; K8 "
              f"{k8_us / 1e3:.3f} ms = {100 * k8_us / 1e6 / dev_s:.1f} %; MGS "
              f"(dot, addcmul) {mgs_us / 1e3:.3f} ms = "
              f"{100 * mgs_us / 1e6 / dev_s:.1f} %; top device ops: {top}")
    phase(15, f"the {applies} ILUT applies alone: wall "
              f"{1e3 * apply_wall:.3f} ms profiled "
              f"({applies * p16['apply_ms']:.3f} ms unprofiled = "
              f"{100 * applies * p16['apply_ms'] / solve_ms:.1f} % of the "
              f"unprofiled solve), device {1e3 * apply_dev_s:.3f} ms = "
              f"{100 * apply_dev_s / dev_s:.1f} % of the solve's device time,"
              f" {sum(c for _, _, c in apply_rows) / applies:.1f} device ops "
              f"per apply | {card_line()}")


def profile_ic(p17):
    """Phase 15, third part: phase 17's IC(t) apply under torch.profiler,
    by block solves (K8) and by level-scheduled solves: device time and
    device ops per apply, over five applies each."""
    for mode, ms in (("block", p17["apply_ms"]), ("level", p17["level_ms"])):
        prec, v = p17[mode], p17["v"]
        wall, dev_s, rows = profile_call(
            lambda: [prec.apply_any(v) for _ in range(5)])
        if not rows:
            phase(15, f"profiled IC(t) apply ({mode}): the profiler saw no "
                      "device time (not measured)")
            continue
        phase(15, f"IC(t) apply by {mode} solves (phase 17's factor, n="
                  f"{v.shape[0]}): device {1e3 * dev_s / 5:.4f} ms per "
                  f"apply, {sum(c for _, _, c in rows) / 5:.1f} device ops "
                  f"per apply; wall {1e3 * wall / 5:.3f} ms profiled, "
                  f"{ms:.3f} ms unprofiled | {card_line()}")


class HostReads:
    """Counts the solvers' device-to-host reads while active: the
    ``_host`` of ``linear/krylov.py`` (GMRES, the replacement solvers) and
    of ``linear/refine.py`` (the refinement passes)."""

    def __enter__(self):
        from pysolvers_tpu_torch.linear import krylov, refine
        self.n, self._mods = 0, (krylov, refine)
        self._real = krylov._host

        def counted(t):
            self.n += 1
            return self._real(t)
        for mod in self._mods:
            mod._host = counted
        return self

    def __exit__(self, *exc):
        for mod in self._mods:
            mod._host = self._real


def by_dtype(kernels):
    """{"K1 f32": n, "K1 f64": n, ...} of the launches counted by dtype
    since the last reset, for ``kernels``."""
    from pysolvers_tpu_torch.ops import _cuda_build
    c = _cuda_build.launches_by_dtype
    return {f"{k} {short}": c[k, d] for k in kernels
            for d, short in (("float32", "f32"), ("float64", "f64"))}


def mixed_path(phases, kernel):
    """The kernels-record ``path_launches`` entries of ``kernel`` from
    phases' launches by dtype: {"phase 21 PCG f32": n, ...}."""
    return {f"{ph} {d}": counts[f"{kernel} {d}"]
            for ph, counts in phases.items() for d in ("f32", "f64")}


def mixed_gate(tag, st, iters_native, resid, err, err_limit):
    """The mixed route's gates: CONVERGED, host residual, error against x*
    and at most MIXED_ITERS_FACTOR times the native iterations."""
    if (st.reason.name != "CONVERGED" or resid > RESID_LIMIT
            or err > err_limit
            or st.iters > MIXED_ITERS_FACTOR * iters_native):
        raise SystemExit(f"{tag}: reason={st.reason.name} iters={st.iters} "
                         f"(native {iters_native}) resid={resid:.3e} "
                         f"err={err:.3e} (limit {err_limit:g})")


def timed(fn):
    """(result, wall seconds) of fn, synchronized."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def mixed_banded(device, p4, p5, p18, m=1023):
    """Phase 21: the banded lane at mixed precision.  solve() with no
    device on phase 5's system (at m = 1023 its default 2-level AMG would
    need a dense coarse inverse of ~175k unknowns); PCG and GMRES with
    AMG(2, 6) on phase 4's operator, frozen, the first solve and the median
    of five re-solves beside phases 4 and 18.  Returns K1's launches by
    dtype."""
    import pysolvers_tpu_torch as pt
    card = card_line()
    out = {}
    H = pt.problems.fd_laplacian_2d(150)
    x_star = np.random.default_rng(3).random(H.shape[0])
    b = H.matvec(x_star)
    reset_launches()
    with HostReads() as reads:
        st, wall = timed(lambda: pt.solve(H, b, tau=1e-10,
                                          precision="mixed"))
    resid, err = check_solution("phase 21 solve()", H, b, x_star, st, device)
    mixed_gate("phase 21 solve()", st, p5["iters"], resid, err, 1e-6)
    if st.soln.dtype.itemsize != 8:
        raise SystemExit("phase 21: the mixed solution is not f64")
    phase(21, f"solve(fd_laplacian_2d(150), b, tau=1e-10, precision="
              f"'mixed') with no device: solution {st.soln.dtype} on "
              f"{st.soln.device}; iters={st.iters} reason={st.reason.name} "
              f"host rel resid={resid:.3e} err={err:.3e}; {wall:.3f} s "
              f"(setup included) | native (phase 5): iters={p5['iters']} "
              f"{p5['wall']:.3f} s err={p5['err']:.3e}; launches "
              f"{by_dtype(('K1',))}; host reads {reads.n} = "
              f"{reads.n / st.iters:.2f} per iteration | {card}")
    out["phase 21 solve()"] = by_dtype(("K1",))
    H = pt.problems.fd_laplacian_2d(m)
    x_star = np.random.default_rng(2).random(H.shape[0])
    b = H.matvec(x_star)
    for name, factory, native in (
            ("PCG", pt.PCG, dict(iters=p4["iters"], solve_s=p4["solve_s"],
                                 what="phase 4 PCG")),
            ("GMRES", pt.GMRES, dict(iters=p18["mgs"]["iters"],
                                     solve_s=p18["mgs"]["repeat_s"],
                                     what="phase 18 GMRES mgs"))):
        solver = factory(pt.CommonSolverArgs(maxiter=500, tau=1e-10),
                         precond=pt.AMG(num_iters=2, num_levels=6),
                         precision="mixed").make_solver()
        solver.freeze_matrix()
        solver.freeze_prec()
        reset_launches()
        with HostReads() as reads:
            st, first_s = timed(lambda: solver.solve(H, b))
        launches = by_dtype(("K1",))
        resid, err = check_solution(f"phase 21 {name}", H, b, x_star, st,
                                    device)
        mixed_gate(f"phase 21 {name}", st, native["iters"], resid, err, 1e-6)
        A32 = solver._mx["A32"]
        walls = []
        for _ in range(5):
            st2, w = timed(lambda: solver.solve(H, b))
            walls.append(w)
        check_solution(f"phase 21 {name} re-solve", H, b, x_star, st2,
                       device)
        med = statistics.median(walls)
        if launches["K1 f32"] <= 0 or launches["K1 f64"] <= 0:
            raise SystemExit(f"phase 21 {name}: launches {launches}")
        phase(21, f"{name}(maxiter=500, tau=1e-10) + AMG(num_iters=2, "
                  f"num_levels=6), precision='mixed', frozen, "
                  f"fd_laplacian_2d({m}) n={H.shape[0]}: f32 operator "
                  f"{type(A32).__name__} {A32.dtype}; iters={st.iters} "
                  f"reason={st.reason.name} host rel resid={resid:.3e} err="
                  f"{err:.3e}; first solve {first_s:.3f} s (setup included),"
                  f" re-solve {1e3 * med:.3f} ms, the median of "
                  f"{[round(1e3 * w, 3) for w in walls]} "
                  f"({1e3 * med / st2.iters:.3f} ms/iter) | native "
                  f"({native['what']}): {native['iters']} iters, "
                  f"{1e3 * native['solve_s']:.3f} ms "
                  f"({1e3 * native['solve_s'] / native['iters']:.3f} ms/iter)"
                  f"; launches {launches}; host reads {reads.n} = "
                  f"{reads.n / st.iters:.2f} per iteration | {card}")
        out[f"phase 21 {name}"] = launches
        del solver
    return out


def mixed_unstructured(device, path, num_levels=4):
    """Phase 22: PCG + BWS SA-AMG at mixed precision on the unpermuted FEM
    matrix of phase 7: the route packs its own RCM-ordered f32 BWS
    operator (K2 f32) and an f64 pack of the permuted matrix as the oracle
    (K2 f64).  The first solve and the median of five re-solves beside
    phase 7's native re-solve.  Returns K2's launches by dtype."""
    import pysolvers_tpu_torch as pt
    from pysolvers_tpu_torch.utils.timing import Timer
    A = path["A"]
    x_star = np.random.default_rng(7).normal(size=A.shape[0])
    b = A.matvec(x_star)
    solver = pt.PCG(pt.CommonSolverArgs(maxiter=500, tau=1e-10),
                    precond=pt.AMG(num_iters=2, num_levels=num_levels,
                                   galerkin="host", matrix_format="bws"),
                    precision="mixed").make_solver()
    solver.freeze_matrix()
    solver.freeze_prec()
    Timer.reset()
    reset_launches()
    with HostReads() as reads:
        st, first_s = timed(lambda: solver.solve(A, b))
    launches = by_dtype(("K1", "K2", "K3"))
    resid, err = check_solution("phase 22", A, b, x_star, st, device,
                                UNSTRUCTURED_ERR_LIMIT)
    mixed_gate("phase 22", st, path["iters"], resid, err,
               UNSTRUCTURED_ERR_LIMIT)
    if launches["K2 f32"] <= 0 or launches["K2 f64"] <= 0:
        raise SystemExit(f"phase 22: launches {launches}")
    walls = []
    for _ in range(5):
        st2, w = timed(lambda: solver.solve(A, b))
        walls.append(w)
    check_solution("phase 22 re-solve", A, b, x_star, st2, device,
                   UNSTRUCTURED_ERR_LIMIT)
    med = statistics.median(walls)
    A32, A64 = solver._mx["A32"], solver._mx["A64"]
    phase(22, f"PCG + AMG(num_iters=2, num_levels={num_levels}, "
              f"matrix_format='bws'), precision='mixed', on "
              f"fem_poisson_2d_unstructured(1025, seed=3) n={A.shape[0]} "
              f"(unpermuted): f32 operator {type(A32).__name__} {A32.dtype} "
              f"(RCM), oracle {type(A64).__name__} {A64.dtype}; iters="
              f"{st.iters} reason={st.reason.name} host rel resid="
              f"{resid:.3e} err={err:.3e}; first solve {first_s:.3f} s (SA "
              f"hierarchy {Timer.total('amg.host_hierarchy'):.3f} s, device "
              f"lowering {Timer.total('amg.device_lower'):.3f} s), re-solve "
              f"{1e3 * med:.3f} ms, the median of "
              f"{[round(1e3 * w, 3) for w in walls]} ({st2.iters} iters) | "
              f"native (phase 7): {path['iters']} iters, "
              f"{1e3 * path['solve_s']:.3f} ms, err={path['err']:.3e}; "
              f"launches {launches}; host reads {reads.n} = "
              f"{reads.n / st.iters:.2f} per iteration | {card_line()}")
    return launches


def mixed_block(device, p10, p11):
    """Phase 23: the block lane at mixed precision, full width, on phase
    9's operator built anew (phases 12-13 run without it, as before):
    "auto" (block-Jacobi, K4 f32 inside, K4 f64 as the oracle) with one
    right-hand side beside phase 10, and k = 8 through cg_lockstep_rr (K5
    f32 for the operator and block-Jacobi, K5 f64 for the replacements)
    beside phase 11, per column.  Returns K4's and K5's launches."""
    import importlib
    import pysolvers_tpu_torch as pt
    tsolve = importlib.import_module("pysolvers_tpu_torch.solve")
    card = card_line()
    H, A, _, _ = block_operator(device)
    x_star = np.random.default_rng(0).random(H.shape[0])
    b = H.matvec(x_star)
    reset_launches()
    with HostReads() as reads:
        st, first_s = timed(lambda: pt.solve(A, b, tau=1e-10,
                                             maxiter=BLOCK_MAXITER,
                                             precision="mixed"))
    single = by_dtype(("K4", "K5"))
    resid, err = check_solution("phase 23 auto", H, b, x_star, st, device,
                                BLOCK_ERR_LIMIT)
    mixed_gate("phase 23 auto", st, p10["iters"], resid, err,
               BLOCK_ERR_LIMIT)
    st2, repeat_s = timed(lambda: pt.solve(A, b, tau=1e-10,
                                           maxiter=BLOCK_MAXITER,
                                           precision="mixed"))
    check_solution("phase 23 auto repeat", H, b, x_star, st2, device,
                   BLOCK_ERR_LIMIT)
    if single["K4 f32"] <= 0 or single["K4 f64"] <= 0:
        raise SystemExit(f"phase 23 auto: launches {single}")
    phase(23, f"solve(BdiaMatrix fd_vector_laplacian_2d({BLOCK_M}, b="
              f"{BLOCK_B}), b, precision='mixed') 'auto' n={H.shape[0]}: "
              f"f32 operator {A.dtype} -> float32 planes; iters={st.iters} "
              f"reason={st.reason.name} host rel resid={resid:.3e} err="
              f"{err:.3e}; first {first_s:.3f} s (f32 cast and block-Jacobi "
              f"included), repeat {repeat_s:.3f} s = "
              f"{1e3 * repeat_s / st2.iters:.3f} ms/iter | native (phase "
              f"10): {p10['iters']} iters, {p10['repeat_s']:.3f} s = "
              f"{1e3 * p10['repeat_s'] / p10['iters']:.3f} ms/iter; "
              f"launches {single}; host reads {reads.n} = "
              f"{reads.n / st.iters:.3f} per iteration | {card}")
    X_star = np.random.default_rng(1).random((H.shape[0], BLOCK_K))
    B = np.stack([H.matvec(X_star[:, j]) for j in range(BLOCK_K)], axis=1)
    cols = []
    lock = tsolve.cg_lockstep_rr

    def recording(*a, **k):
        out = lock(*a, **k)
        cols.append(out[1])
        return out
    tsolve.cg_lockstep_rr = recording
    try:
        reset_launches()
        with HostReads() as reads:
            st, wall = timed(lambda: pt.solve(A, B, tau=1e-10,
                                              maxiter=BLOCK_MAXITER,
                                              precision="mixed"))
    finally:
        tsolve.cg_lockstep_rr = lock
    multi = by_dtype(("K4", "K5"))
    X = st.soln.cpu().numpy()
    resids = [host_residual(H, X[:, j], B[:, j]) for j in range(BLOCK_K)]
    errs = [float(np.linalg.norm(X[:, j] - X_star[:, j])
                  / np.linalg.norm(X_star[:, j])) for j in range(BLOCK_K)]
    mixed_gate("phase 23 k=8", st, p11["iters"], max(resids), max(errs),
               BLOCK_ERR_LIMIT)
    if len(cols) != 1 or multi["K5 f32"] <= 0 or multi["K5 f64"] <= 0:
        raise SystemExit(f"phase 23 k=8: launches {multi}, lockstep runs "
                         f"{len(cols)}")
    phase(23, f"solve(BdiaMatrix, B, precision='mixed') k={BLOCK_K} "
              f"cg_lockstep_rr: iters={st.iters} (max) per column "
              f"{cols[0].k.tolist()} reason={st.reason.name}; wall "
              f"{wall:.3f} s = {1e3 * wall / st.iters:.3f} ms/iter; host rel "
              f"resid per column {[f'{r:.2e}' for r in resids]}; err vs X* "
              f"max {max(errs):.3e} | native (phase 11): {p11['iters']} "
              f"iters, {p11['wall']:.3f} s = "
              f"{1e3 * p11['wall'] / p11['iters']:.3f} ms/iter; launches "
              f"{multi}; host reads {reads.n} = {reads.n / st.iters:.3f} per "
              f"iteration | {card}")
    return single, multi


def mixed_grid(device, p13, m=GRID_M, num_levels=GRID_LEVELS):
    """Phase 24: benchmarks/hbm_solve.py's run_solve route at m = 10239:
    the f32 (5, n) table, the f32 device-probed hierarchy (K6 f32 on the
    two finest levels, K1 f32 below), cg_solve_rr(hi_matvec=False,
    maxiter=200, tau=1e-10) with two V-cycles, the f64 oracle K6 on an f64
    grid table built from the f64 host table; checked on the host by the
    matrix-free f64 stencil.  First and repeat solve, replacements, peak
    memory beside phase 13; a profiled repeat; the hi-dots' and the f64
    x update's device time (CUDA events at this n) times their calls per
    solve.  Returns K1's and K6's launches by dtype."""
    import torch
    from pysolvers_tpu_torch.linear.gmg_grid import (
        build_grid_hierarchy_device, grid_vc_apply)
    from pysolvers_tpu_torch.linear.krylov import _dot64, cg_solve_rr
    from pysolvers_tpu_torch.ops import matvec
    from pysolvers_tpu_torch.ops.grid_spmv import GridDiaMatrix
    from pysolvers_tpu_torch.sparse.device import DiaMatrix
    card = card_line()
    n = m * m
    b, x_star = p13["b"], p13["x_star"]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    diags, offsets = lap2d_dia(m)
    assembly_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    A32 = DiaMatrix.from_numpy(diags, offsets, (n, n), dtype=np.float32,
                               device=device)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    h = build_grid_hierarchy_device(A32, num_levels, (m, m),
                                    smoother="jacobi")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    del A32
    # the f64 oracle from the f64 host table, never cast up from f32
    A64 = DiaMatrix.from_numpy(diags, offsets, (n, n), device=device)
    del diags
    G64 = GridDiaMatrix.from_dia_device(A64, (m, m))
    del A64
    torch.cuda.synchronize()
    A_f = h.levels[-1].A_dev
    if not isinstance(A_f, GridDiaMatrix) or A_f.dtype != torch.float32:
        raise SystemExit(f"phase 24: the fine level is {type(A_f).__name__} "
                         f"{A_f.dtype}")
    levels = [(mk, type(L.A_dev).__name__, str(L.A_dev.dtype)[6:])
              for mk, L in zip(h.ms[1:], h.levels[1:])]
    vc2 = grid_vc_apply(2)
    b_dev = torch.as_tensor(b, device=device)
    replacements = []

    def mv_hi(v):
        replacements.append(1)
        return matvec(G64, v)

    def solve():
        replacements.clear()
        return cg_solve_rr(lambda v: matvec(A_f, v), b_dev, mv_hi=mv_hi,
                           maxiter=200, tau=1e-10,
                           precond=lambda r: vc2(h, r), hi_matvec=False)

    reset_launches()
    with HostReads() as reads:
        (x, st, _), first_s = timed(solve)
    launches = by_dtype(("K1", "K6"))
    n_rep = len(replacements)
    xh = x.cpu().numpy()
    del x
    resid = float(np.linalg.norm(b - lap2d_matvec(m, xh)) / np.linalg.norm(b))
    err = float(np.linalg.norm(xh - x_star) / np.linalg.norm(x_star))
    del xh
    if (st.reason != 1 or resid > RESID_LIMIT or err > GRID_ERR_LIMIT
            or st.k > MIXED_ITERS_FACTOR * p13["iters"]
            or launches["K6 f32"] <= 0 or launches["K6 f64"] <= 0
            or launches["K1 f32"] <= 0):
        raise SystemExit(f"phase 24: reason={st.reason} iters={st.k} "
                         f"resid={resid:.3e} err={err:.3e} launches "
                         f"{launches}")
    (_, st2, _), repeat_s = timed(solve)
    peak_abs = torch.cuda.max_memory_allocated() / 1e9
    peak = peak_abs - base / 1e9
    phase(24, f"Lap2D(m={m}) n={n} f32 route: host assembly "
              f"{assembly_s:.3f} s, f32 upload {upload_s:.3f} s, f32 "
              f"hierarchy {setup_s:.3f} s; levels (m, format, dtype) "
              f"{levels}, coarsest inverse {h.A0_inv.dtype}; oracle "
              f"{type(G64).__name__} {G64.dtype}")
    phase(24, f"cg_solve_rr(hi_matvec=False, maxiter=200, tau=1e-10) + 2 "
              f"V-cycles: iters={st.k} reason=CONVERGED host rel resid="
              f"{resid:.3e} (matrix-free f64 stencil) err={err:.3e}; first "
              f"solve {first_s:.3f} s, repeat {repeat_s:.3f} s = "
              f"{1e3 * repeat_s / st2.k:.3f} ms/iter ({st2.k} iters), "
              f"replacements {n_rep}; peak device memory {peak:.2f} GB above "
              f"the phase's start ({peak_abs:.2f} GB in all) | native (phase "
              f"13): {p13['iters']} iters, first {p13['first_s']:.3f} s, "
              f"repeat {p13['repeat_s']:.3f} s, peak {p13['peak_above']:.2f} "
              f"GB above its start ({p13['peak']:.2f} GB in all), err="
              f"{p13['err']:.3e}, hierarchy {p13['setup_s']:.3f} s; launches "
              f"{launches}; host "
              f"reads {reads.n} = {reads.n / st.k:.2f} per iteration | "
              f"{card}")
    wall, dev_s, rows = profile_call(solve)
    # the f64 parts of an iteration alone, CUDA events at this n: three
    # hi-dots (p·Ap, the recurrence norm, u·r; a replacement adds one) and
    # one x update
    p = torch.rand(n, device=device)
    q = torch.rand(n, device=device)
    x64 = torch.zeros(n, dtype=torch.float64, device=device)
    alpha = torch.tensor(0.5, dtype=torch.float64, device=device)
    dot_ms, upd_ms, _ = time_pair(lambda: _dot64(p, q),
                                  lambda: x64.addcmul_(p.to(torch.float64),
                                                       alpha), runs=5)
    del p, q, x64
    dots = 3 * st2.k + n_rep + 2          # and b's norm and u0·r0
    if rows:
        top = "; ".join(f"{k[:60]} {us / 1e3:.3f} ms x{c}"
                        for us, k, c in rows[:8])
        phase(24, f"profiled repeat: wall {wall:.3f} s, device {dev_s:.3f} "
                  f"s, busy {100 * dev_s / wall:.1f} % (phase 13: "
                  f"{p13['busy'] and round(p13['busy'], 1)} %); hi-dots "
                  f"{dots} x {dot_ms:.4f} ms = "
                  f"{100 * dots * dot_ms / 1e3 / dev_s:.1f} % of device "
                  f"time, f64 x update {st2.k} x {upd_ms:.4f} ms = "
                  f"{100 * st2.k * upd_ms / 1e3 / dev_s:.1f} %; top device "
                  f"ops: {top} | {card}")
    else:
        phase(24, f"profiled repeat: the profiler saw no device time (busy "
                  f"share not measured); hi-dot {dot_ms:.4f} ms, f64 x "
                  f"update {upd_ms:.4f} ms per call")
    return launches


def mixed_short(device):
    """Phase 25: solve() at mixed precision on fd_convection_diffusion_2d(63)
    with no device: GMRES + ILUT through the mixed route (the f64 FGMRES
    inner with the f32 ILUT apply, f32 block plans on K8), gated on the
    JAX package's block-mode count; the native solve of the same system
    beside it.  Returns K1's and K8's launches by dtype."""
    import pysolvers_tpu_torch as pt
    H = pt.fd_convection_diffusion_2d(CD_MIXED_M)
    x_star = np.random.default_rng(2).random(H.shape[0])
    b = H.matvec(x_star)
    reset_launches()
    with HostReads() as reads, no_degrade():
        st, wall = timed(lambda: pt.solve(H, b, tau=1e-10,
                                          precision="mixed"))
    launches = by_dtype(("K1", "K8"))
    resid, err = check_converged("phase 25", H, b, x_star, st, device)
    near("phase 25", st.iters, CD_MIXED_ITERS)
    if (launches["K1 f64"] <= 0 or launches["K8 f32"] <= 0
            or launches["K8 f64"] or st.soln.dtype.itemsize != 8):
        raise SystemExit(f"phase 25: launches {launches}, {st.soln.dtype}")
    native, native_s = timed(lambda: pt.solve(H, b, tau=1e-10))
    check_converged("phase 25 native", H, b, x_star, native, device)
    phase(25, f"solve(fd_convection_diffusion_2d({CD_MIXED_M}), b, tau=1e-10, "
              f"precision='mixed') n={H.shape[0]} (GMRES + ILUT, f64 FGMRES "
              f"inner, f32 ILUT): iters={st.iters} (JAX {CD_MIXED_ITERS}) "
              f"reason={st.reason.name} host rel resid={resid:.3e} err="
              f"{err:.3e}; {wall:.3f} s (setup included) | native: "
              f"{native.iters} iters, {native_s:.3f} s; launches {launches}; "
              f"host reads {reads.n} = {reads.n / st.iters:.2f} per "
              f"iteration; solution {st.soln.dtype} on {st.soln.device} | "
              f"{card_line()}")
    return launches


# ---------------------------------------------------------------------------
# Phases 27-30: Newton (slice 9) and solve(A, B) (slice 10's rest)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def no_twin_on_cuda():
    """A kernel's plain twin called with a CUDA tensor fails the phase
    (phases 27-30): every product there must be a kernel launch."""
    from pysolvers_tpu_torch.ops import block_trisolve, bws_spmv, grid_spmv
    from pysolvers_tpu_torch.ops import spmv
    twins = ((spmv, "dia_spmv_torch"), (spmv, "bdia_spmv_torch"),
             (spmv, "bdia_spmm_torch"), (bws_spmv, "bws_spmv_torch"),
             (grid_spmv, "grid_dia_spmv_torch"),
             (block_trisolve, "block_trisolve_torch"))
    real = [getattr(mod, name) for mod, name in twins]

    def guard(fn, name):
        def twin(*args, **kwargs):
            if any(getattr(a, "is_cuda", False) for a in args):
                raise SystemExit(f"{name} ran on a CUDA tensor")
            return fn(*args, **kwargs)
        return twin
    for (mod, name), fn in zip(twins, real):
        setattr(mod, name, guard(fn, name))
    try:
        yield
    finally:
        for (mod, name), fn in zip(twins, real):
            setattr(mod, name, fn)


def bratu_host_f(prob, u):
    """F(u) = A u − alpha e^{−u} on the host (scipy), accumulated in
    longdouble, for the gates ||F|| <= r0·tau + tau: in f64 its evaluation
    alone rounds by ≈ |A|·eps64 ≈ 1e-11 at m = 100, a fifth of the bound."""
    import scipy.sparse as sp
    H = prob.A_host
    S = sp.csr_matrix((H.data.astype(np.longdouble), H.indices, H.indptr),
                      shape=H.shape)
    u = np.asarray(u).astype(np.longdouble)
    return (S @ u - np.longdouble(prob.alpha) * np.exp(-u)).astype(
        np.float64)


def newton_gate(tag, st, steps, r0, Fn, tau=1e-12):
    """Newton's gates: the JAX package's steps and stop reason, and the
    host residual within r0·tau + tau."""
    if (st.iters, st.reason.name) != steps or not Fn <= r0 * tau + tau:
        raise SystemExit(f"{tag}: {st.iters} steps {st.reason.name} (JAX "
                         f"{steps}), host ||F|| {Fn:.3e} against "
                         f"{r0 * tau + tau:.3e}")


def inner_log(factory, log):
    """The factory, its solvers recording each solve's iterations and wall
    seconds in ``log``."""
    make = factory.make_solver

    def make_solver():
        s = make()
        solve = s.solve

        def recorded(A, b):
            st, w = timed(lambda: solve(A, b))
            log.append((st.iters, w))
            return st
        s.solve = recorded
        return s
    factory.make_solver = make_solver
    return factory


def newton_small(device):
    """Phase 27: Newton at the reference's sizes on the card (no device
    argument): FuncAdapter1D on x² − 2 and arctan with both line searches
    (examples/newton_example_*.py), and Bratu m = 100 in
    examples/bratu_example.py's configuration at native and mixed
    precision.  Returns K1's launches by dtype."""
    import torch
    import pysolvers_tpu_torch as pt
    card = card_line()
    scalar = {"sqrt2": (lambda x: x * x - 2.0, lambda x: 2.0 * x, 1.0, 20),
              "arctan": (np.arctan, lambda x: 1.0 / (1.0 + x * x), 2.0, 50)}
    for key, steps in NEWTON_1D_STEPS.items():
        name, ls = key.split()
        f, df, x0, maxiter = scalar[name]
        search = (pt.SimpleBacktrack() if ls == "backtrack"
                  else pt.TrivialLinesearch())
        st = pt.NewtonSolver(pt.SolverConfig(maxiter=maxiter, tau=1e-14),
                             linesearch=search).solve(
            pt.FuncAdapter1D(f, df),
            torch.tensor([x0], dtype=torch.float64, device=device))
        if (st.iters, st.reason.name) != steps \
                or st.soln.device.type != device:
            raise SystemExit(f"phase 27 {key}: {st.iters} steps "
                             f"{st.reason.name} on {st.soln.device} (JAX "
                             f"{steps})")
        phase(27, f"FuncAdapter1D {key}: {st.iters} steps "
                  f"{st.reason.name} (JAX {steps}), x = {float(st.soln[0])!r}")
    out = {}
    for precision, steps in BRATU_STEPS.items():
        prob = pt.problems.Bratu2D(m=BRATU_M, alpha=0.5)
        inner = pt.PCG(pt.CommonSolverArgs(maxiter=500, tau=1e-12),
                       precond=pt.AMG(num_iters=5, num_levels=2),
                       precision=precision)
        log = []
        reset_launches()
        st, wall = timed(lambda: pt.NewtonSolver(
            pt.SolverConfig(maxiter=30, tau=1e-12),
            solver=inner_log(inner, log), min_lin_tol=1e-6,
            freeze_prec=True).solve(
                prob, torch.zeros(prob.n, dtype=torch.float64)))
        out[f"phase 27 {precision}"] = by_dtype(("K1",))
        r0 = float(np.linalg.norm(bratu_host_f(prob, np.zeros(prob.n))))
        Fn = float(np.linalg.norm(bratu_host_f(prob, st.soln.cpu())))
        newton_gate(f"phase 27 Bratu {precision}", st, steps, r0, Fn)
        if st.soln.device.type != device or not st.success:
            raise SystemExit(f"phase 27: {st}")
        phase(27, f"Bratu2D(m={BRATU_M}) Newton + PCG(maxiter=500, tau="
                  f"1e-12) + AMG(num_iters=5, num_levels=2), precision="
                  f"{precision!r}, freeze_prec: {st.iters} steps "
                  f"{st.reason.name} (JAX {steps}), host ||F|| {Fn:.3e} <= "
                  f"{r0 * 1e-12 + 1e-12:.3e}; inner iterations "
                  f"{[it for it, _ in log]}; {wall:.3f} s; launches "
                  f"{out[f'phase 27 {precision}']} | {card}")
    return out


def newton_large(device, m=BRATU_LARGE_M, levels=BRATU_LARGE_LEVELS,
                 runs=3):
    """Phase 28: benchmarks/bratu_large.py::run_ours at m = 1023 on the
    card: Bratu2DHostOuter (longdouble F on the host), Newton tau = 1e-12,
    min_lin_tol = 1e-6, freeze_prec, u0 = 1 in longdouble; the inner PCG
    at mixed precision (maxiter 400) preconditioned by two V-cycles of the
    6-level grid GMG with Jacobi smoothing, probed on the card from the f32
    Jacobian.  Setup, the cold solve and the median of ``runs`` steady
    solves; the inner iterations per Newton step; the host share of the
    wall.  Returns K1's and K6's launches by dtype (one steady solve)."""
    import pysolvers_tpu_torch as pt
    card = card_line()
    prob, setup_s = timed(lambda: pt.problems.Bratu2DHostOuter(
        pt.problems.Bratu2D(m=m, alpha=0.5)))
    base = prob.prob
    spent = {"F": [0, 0.0], "J": [0, 0.0]}

    def timed_eval(fn, key):
        def call(u):
            out, w = timed(lambda: fn(u))
            spent[key][0] += 1
            spent[key][1] += w
            return out
        return call
    prob.evalF = timed_eval(prob.evalF, "F")
    prob.evalJ = timed_eval(prob.evalJ, "J")
    u0 = np.ones(prob.n, dtype=np.longdouble)
    r0 = float(np.linalg.norm(bratu_host_f(base, u0)))

    def newton_once():
        log = []
        for v in spent.values():
            v[:] = [0, 0.0]
        inner = pt.PCG(pt.CommonSolverArgs(maxiter=400, tau=1e-12),
                       precond=pt.GMGPreconditionerType(
                           dims=(m, m), num_iters=2, num_levels=levels,
                           smoother="jacobi"),
                       precision="mixed")
        st, wall = timed(lambda: pt.NewtonSolver(
            pt.SolverConfig(maxiter=30, tau=1e-12),
            solver=inner_log(inner, log), min_lin_tol=1e-6,
            freeze_prec=True).solve(prob, u0))
        Fn = float(np.linalg.norm(bratu_host_f(base, st.soln)))
        newton_gate("phase 28", st, BRATU_LARGE_STEPS, r0, Fn)
        if not isinstance(st.soln, np.ndarray) or \
                st.soln.dtype != np.longdouble:
            raise SystemExit("phase 28: the iterate left its longdouble")
        return st, wall, Fn, log, {k: tuple(v) for k, v in spent.items()}

    mem0 = peak_reset()
    st, cold_s, Fn, log, host = newton_once()
    walls = []
    for i in range(runs):
        if i == runs - 1:
            reset_launches()
        st, w, Fn, log, host = newton_once()
        walls.append(w)
    launches = by_dtype(("K1", "K6"))
    if launches["K1 f32"] <= 0 or launches["K1 f64"] <= 0:
        raise SystemExit(f"phase 28: launches {launches}")
    med = statistics.median(walls)
    inner_s = sum(w for _, w in log)
    other = walls[-1] - inner_s - host["F"][1] - host["J"][1]
    phase(28, f"Bratu2DHostOuter(Bratu2D(m={m})) n={prob.n}, Newton "
              f"(tau=1e-12, min_lin_tol=1e-6, freeze_prec, u0=1 longdouble)"
              f" + PCG(maxiter=400, tau=1e-12, precision='mixed') + GMG"
              f"{levels}(grid, jacobi, num_iters=2, probed on the card): "
              f"{st.iters} steps {st.reason.name} (JAX "
              f"{BRATU_LARGE_STEPS}), host ||F|| {Fn:.3e} <= "
              f"{r0 * 1e-12 + 1e-12:.3e}; setup {setup_s:.3f} s, cold "
              f"solve {cold_s:.3f} s, steady {med:.3f} s (the median of "
              f"{[round(w, 3) for w in walls]}); inner iterations per step "
              f"{[it for it, _ in log]}; launches (one steady solve) "
              f"{launches}; peak device memory {peak_above(mem0):.3f} GB "
              f"above the phase's start | "
              f"{card}")
    phase(28, f"host share of the last steady solve ({walls[-1]:.3f} s): "
              f"longdouble F {host['F'][1]:.3f} s in {host['F'][0]} calls "
              f"({host['F'][0] - 1} line-search trials), host and device "
              f"Jacobians {host['J'][1]:.3f} s in {host['J'][0]} calls, "
              f"inner solves {inner_s:.3f} s ({[round(w, 3) for _, w in log]}"
              f"), the rest (the copies of p to the host, the numpy "
              f"updates) {other:.3f} s")
    return launches


def newton_krylov(device, m=NK_M):
    """Phase 29: newton_krylov_solve on Bratu m = NK_M with
    tests/test_newton_krylov.py's settings, matrix-free (J·v by
    torch.func.jvp through K1's autograd.Function: two K1 launches per
    J·v, the tangent's counted apart) and with the explicit DIA Jacobian
    and its Jacobi preconditioner (K1 per product).  Returns K1's launches
    by dtype per run."""
    import torch
    import pysolvers_tpu_torch as pt
    from pysolvers_tpu_torch.ops import spmv
    card = card_line()
    out = {}
    prob = pt.problems.Bratu2D(m=m)
    x0 = torch.zeros(prob.n, dtype=torch.float64, device=device)
    # the first torch.func.jvp of the process sets up its machinery
    _, first_s = timed(lambda: torch.func.jvp(prob.eval_f, (x0,), (x0,)))
    _, second_s = timed(lambda: torch.func.jvp(prob.eval_f, (x0,), (x0,)))
    phase(29, f"the process's first J·v by torch.func.jvp {first_s:.3f} s, "
              f"the second {1e3 * second_s:.3f} ms")
    for name, kw in (("jvp", dict(inner_maxiter=300)),
                     ("explicit J + Jacobi", dict(
                         inner_maxiter=500, eval_j=prob.eval_j_dev,
                         precond_from_j=prob.jacobi_precond))):
        reset_launches()
        (x, st), wall = timed(lambda: pt.nonlinear.newton_krylov_solve(
            prob.eval_f, x0, tau=1e-12, maxiter=30, method="cg",
            min_lin_tol=1e-8, **kw))
        jvps = spmv.dia_spmv_jvp_launches
        out[f"phase 29 {name}"] = by_dtype(("K1",))
        k_ref, inner_ref, reason_ref = NK_COUNTS[name]
        r0 = float(np.linalg.norm(bratu_host_f(prob, np.zeros(prob.n))))
        Fn = float(np.linalg.norm(bratu_host_f(prob, x.cpu())))
        # each inner CG makes one J·v per iteration and one at its start
        want_jvps = st.inner_total + st.k if name == "jvp" else 0
        if (st.k != k_ref or pt.StopReason(st.reason).name != reason_ref
                or abs(st.inner_total - inner_ref) > ITERS_SLACK * inner_ref
                or not Fn <= r0 * 1e-12 + 1e-12 or jvps != want_jvps
                or x.device.type != device):
            raise SystemExit(f"phase 29 {name}: k={st.k} inner="
                             f"{st.inner_total} reason={st.reason} (JAX "
                             f"{NK_COUNTS[name]}), ||F|| {Fn:.3e}, tangent "
                             f"launches {jvps} (want {want_jvps})")
        phase(29, f"newton_krylov_solve(Bratu2D(m={m}) n={prob.n}, "
                  f"method='cg', tau=1e-12, min_lin_tol=1e-8, {name}): "
                  f"k={st.k} inner_total={st.inner_total} "
                  f"{pt.StopReason(st.reason).name} (JAX {NK_COUNTS[name]}),"
                  f" host ||F|| {Fn:.3e}; {wall:.3f} s; launches "
                  f"{out[f'phase 29 {name}']}, of K1 for J·v tangents "
                  f"{jvps} | {card}")
    return out


@contextlib.contextmanager
def inner_passes():
    """The per-column iterations of each f32 ``gmres_solve_multi`` that
    solve()'s mixed route runs inside ``ir_solve_multi``, one tuple per
    refinement pass."""
    import torch
    mod = sys.modules["pysolvers_tpu_torch.solve"]
    real = mod.gmres_solve_multi
    passes = []

    def recorded(mm, R, **kw):
        X, st, h = real(mm, R, **kw)
        if R.dtype == torch.float32:
            passes.append(tuple(int(k) for k in st.k))
        return X, st, h
    mod.gmres_solve_multi = recorded
    try:
        yield passes
    finally:
        mod.gmres_solve_multi = real


def multi_rhs(device):
    """Phase 30: solve(A, B) with k = 8 right-hand sides on phase 5's
    fd_laplacian_2d(150) (n = 22,500, where "auto" is PCG + AMG(2, 2) or,
    for GMRES, ILUT by K8): lockstep CG and GMRES (gmres_solve_multi) at
    native and mixed precision (mixed GMRES unrestarted, solve()'s default,
    and restarted at 60), the column loop for orthog='cgs2', the direct
    solve at n = 484, and an unstructured fem_poisson_2d_unstructured(151)
    (n = 22,500) at mixed precision, whose f32 and f64 operators are
    RCM-ordered BWS packs (K2 per column).  Gates: CONVERGED, each column's
    host residual <= 1e-9, the JAX package's iterations within ITERS_SLACK
    (unrestarted mixed GMRES: MIXED_GMRES_PASS1 and MIXED_GMRES_TOTALS).
    The native routes, the direct
    solve and the FEM route beside k single solve() calls.  Returns the
    launches by dtype per route."""
    import pysolvers_tpu_torch as pt
    card = card_line()

    def block(H):
        X = np.random.default_rng(2).random((MULTI_K, H.shape[0]))
        return np.stack([H.matvec(x) for x in X], axis=1)

    H = pt.problems.fd_laplacian_2d(MULTI_M)
    Hd = pt.problems.fd_laplacian_2d(DIRECT_M)
    Hf = pt.problems.fem_poisson_2d_unstructured(FEM_MULTI_M, seed=3)
    routes = (("cg", H, dict(method="cg")),
              ("gmres", H, dict(method="gmres")),
              ("cg mixed", H, dict(method="cg", precision="mixed")),
              ("gmres mixed", H, dict(method="gmres", precision="mixed")),
              # beside it, restarted as the factories' mixed GMRES
              ("gmres mixed restart=60", H, dict(
                  method="gmres", precision="mixed", restart=60)),
              ("gmres cgs2", H, dict(method="gmres", orthog="cgs2")),
              ("direct", Hd, dict(method="direct")),
              ("fem cg jacobi mixed", Hf, dict(method="cg", precond="jacobi",
                                               precision="mixed")))
    out = {}
    for name, A, kw in routes:
        B = block(A)
        reset_launches()
        with HostReads() as reads, inner_passes() as passes:
            st, wall = timed(lambda: pt.solve(A, B, tau=1e-10, **kw))
        launches = by_dtype(("K1", "K2", "K8"))
        out[f"phase 30 {name}"] = launches
        X = st.soln
        if (st.reason.name != "CONVERGED" or X.device.type != device
                or tuple(X.shape) != B.shape):
            raise SystemExit(f"phase 30 {name}: {st}")
        Xh = X.cpu().numpy()
        resid = max(host_residual(A, Xh[:, j], B[:, j])
                    for j in range(MULTI_K))
        if name == "gmres mixed":
            ref = MIXED_GMRES_TOTALS
            pass1 = passes[0] if passes else ()
            counts_ok = len(pass1) == MULTI_K and all(
                abs(k - r) <= ITERS_SLACK * r
                for k, r in zip(pass1, MIXED_GMRES_PASS1)) and any(
                abs(st.iters - r) <= ITERS_SLACK * r for r in ref)
        else:
            ref = MULTI_ITERS[name]
            counts_ok = abs(st.iters - ref) <= ITERS_SLACK * ref
        if resid > RESID_LIMIT or not counts_ok:
            raise SystemExit(f"phase 30 {name}: iters={st.iters} (JAX "
                             f"{ref}), inner passes {passes}, max column "
                             f"resid {resid:.3e}")
        needs = {"gmres": ("K8 f64",), "gmres cgs2": ("K8 f64",),
                 "gmres mixed": ("K8 f32",),
                 "gmres mixed restart=60": ("K8 f32",),
                 "fem cg jacobi mixed": ("K2 f32", "K2 f64")}
        if any(launches[k] <= 0 for k in needs.get(name, ())):
            raise SystemExit(f"phase 30 {name}: launches {launches}")
        if name in ("cg mixed", "gmres mixed", "gmres mixed restart=60",
                    "gmres cgs2"):
            # the column loop is k single solves sharing one setup; the
            # mixed GMRES singles (thousands of f32 steps each) would take
            # longer than the rest of the phase; the mixed CG singles
            # repeat the native ones' eight host SA setups (6 s)
            singles_text = "single solve() calls not run"
        else:
            singles, single_s = timed(lambda: [
                pt.solve(A, B[:, j], tau=1e-10, **kw)
                for j in range(MULTI_K)])
            if not all(s.success for s in singles):
                raise SystemExit(f"phase 30 {name}: a single solve failed")
            singles_text = (f"against {single_s:.3f} s for {MULTI_K} single "
                            f"solve() calls (iters "
                            f"{[s.iters for s in singles]})")
        phase(30, f"solve(n={A.shape[0]}, B (n, {MULTI_K}), tau=1e-10, "
                  f"{', '.join(f'{k}={v!r}' for k, v in kw.items())}): "
                  f"iters={st.iters} (JAX {ref}) reason={st.reason.name}"
                  f"{f', inner passes {passes}' if passes else ''}, "
                  f"max column host rel resid {resid:.3e}; {wall:.3f} s "
                  f"{singles_text}; launches {launches}; host reads "
                  f"{reads.n} | {card}")
    return out


def build_bws_variant(spec):
    """(spec, library, ptxas registers) of a copy of csrc/bws_spmv.cu with
    the sizes of ``spec`` ("THREADS,UNROLL,EVICT_FIRST"), built under
    _build/sweep."""
    from pysolvers_tpu_torch.ops import _cuda_build
    threads, unroll, evict = spec.split(",")
    with open(os.path.join(_cuda_build.CSRC_DIR, "bws_spmv.cu")) as f:
        src = f.read()
    for old, new in (
            ("constexpr int kThreads = 256;",
             f"constexpr int kThreads = {threads};"),
            ("constexpr int kUnroll = 4;", f"constexpr int kUnroll = {unroll};"),
            ("return __ldcs(p);",
             "return __ldcs(p);" if evict == "1" else "return *p;")):
        if src.count(old) != 1:
            raise SystemExit(f"bws_spmv.cu no longer holds {old!r}")
        src = src.replace(old, new)
    out = os.path.join(_cuda_build.BUILD_DIR, "sweep")
    os.makedirs(out, exist_ok=True)
    cu = os.path.join(out, f"bws_spmv_{spec.replace(',', '_')}.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = cu[:-3] + ".so"
    proc = subprocess.run([_cuda_build._nvcc(), *_cuda_build.NVCC_FLAGS,
                           "-o", so, cu], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {spec}:\n{proc.stderr}")
    regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers",
                                              proc.stdout + proc.stderr)})
    return spec, so, regs


def bws_sweep(specs):
    """K2's sizes against each other and the CSR product: every variant on
    the unstructured path's fine operator (f64 and f32, the CSR call
    beside it) and on graph_laplacian_rgg(1e6) (RCM, f64), over the
    matrix's own device CSR and row blocks.  Each is checked against the
    twin (``BWS_TOL``), then timed by the profiler (device time alone) and
    by CUDA events (``time_pair``, in turns with the CSR call)."""
    import ctypes
    import torch
    import pysolvers_tpu_torch as pt
    from pysolvers_tpu_torch.ops import bws_spmv
    from pysolvers_tpu_torch.sparse.bws import BwsMatrix
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(specs)) as pool:
        built = list(pool.map(build_bws_variant, specs))
    print(f"[sweep] built {len(built)} variants in "
          f"{time.perf_counter() - t0:.1f} s; registers "
          f"{[(s, r) for s, _, r in built]}", flush=True)
    H = pt.problems.fem_poisson_2d_unstructured(1025, seed=3)
    H = H.permute_symmetric(BwsMatrix._rcm_perm(H))
    f64 = BwsMatrix.from_host_csr(H, dtype=np.float64, use_rcm=False,
                                  device="cuda")
    f32 = BwsMatrix.from_host_csr(H, dtype=np.float32, use_rcm=False,
                                  group_rows=f64.group_rows, gt=f64.gt,
                                  device="cuda")
    G = BwsMatrix.from_host_csr(
        pt.problems.graph_laplacian_rgg(1_000_000, seed=1),
        dtype=np.float64, use_rcm=True, device="cuda")
    dev = torch.cuda.current_device()
    rng = np.random.default_rng(0)
    for name, A, host in (("fine FEM", f64, H), ("fine FEM", f32, H),
                          ("graph_laplacian_rgg(1e6) RCM", G, None)):
        dt = str(A.dtype).split(".")[1]
        L = A.csr
        x = torch.as_tensor(rng.standard_normal(A.n_cols), dtype=A.dtype,
                            device="cuda")
        y_ref = bws_spmv.bws_spmv_torch(A, x)
        size = A.data.element_size()
        bnd = bound((size + 4) * L.nnz + 4 * (A.n_rows + 1)
                    + size * (A.n_cols + A.n_rows), 2 * L.nnz, dt)["bound_ms"]
        lib = lib_line = None
        if host is not None:
            S = csr_of_host(host, A.dtype, x.device)
            lib = lambda: S @ x                                  # noqa: E731
            lib_line = f"CSR @ x device {device_ms(lib)} ms"
        for spec, so, _ in built:
            fn = getattr(ctypes.CDLL(so), "bws_spmv_" + dt.replace(
                "float", "f") + ("_i32" if L.indptr.dtype == torch.int32
                                 else "_i64"))
            fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong]
                           + [ctypes.c_void_p] * 5
                           + [ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int

            def call(fn=fn):
                y = torch.empty(A.n_rows, dtype=A.dtype, device="cuda")
                rc = fn(L.row_blocks.data_ptr(), L.n_blocks,
                        L.indptr.data_ptr(), L.indices.data_ptr(),
                        L.values.data_ptr(), x.data_ptr(), y.data_ptr(), dev,
                        torch._C._cuda_getCurrentRawStream(dev))
                if rc:
                    raise SystemExit(f"{spec}: CUDA error {rc}")
                return y
            y = call()
            torch.cuda.synchronize()
            rel = float((y - y_ref).abs().max() / y_ref.abs().max())
            if not rel <= BWS_TOL[dt]:
                raise SystemExit(f"{spec} {name} {dt}: rel {rel:.3e}")
            ms, lib_ms, _ = time_pair(call, lib or call, runs=11)
            d_ms = device_ms(call)
            share = "" if d_ms is None else f" ({100 * bnd / d_ms:.1f} %)"
            print(f"[sweep] {name} {dt} THREADS,UNROLL,EVICT_FIRST={spec} "
                  f"rel_err={rel:.2e}: device {d_ms} ms{share}, events "
                  f"{ms:.4f} ms; bound {bnd:.4f} ms"
                  + (f" | {lib_line}, events {lib_ms:.4f} ms" if lib_line
                     else ""), flush=True)
    print(card_line(), flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script runs only on the GPU")
    sys.path.insert(0, ROOT)
    import pysolvers_tpu_torch
    if not os.path.abspath(pysolvers_tpu_torch.__file__).startswith(
            ROOT + os.sep):
        raise SystemExit("pysolvers_tpu_torch is not this checkout's")
    card = card_line()
    print(card, flush=True)
    if sys.argv[1:2] == ["--bws-sweep"]:
        bws_sweep(sys.argv[2:] or BWS_SWEEP)
        return
    phase(1, f"torch {torch.__version__} CUDA {torch.version.cuda} "
             f"device {torch.cuda.get_device_name(0)} "
             f"count {torch.cuda.device_count()}")
    build_kernels()

    rec_k1 = check_k1("cuda")
    k1_launches, p4 = main_path("cuda")
    p5 = front_end("cuda")
    rec_k7 = probe_k7("cuda")
    num_levels = 4
    path = unstructured_path("cuda", num_levels=num_levels)
    counts = path["counts"]
    rec_bws, fine32 = check_bws_kernels(bws_operators(
        path["Ap"], path["A_bws"], path["solver"], num_levels), "cuda")
    H_blk, A_blk, gen_s, pack_s = block_operator("cuda")
    rec_bdia = check_bdia_kernels(A_blk, "cuda")
    p10 = block_single(H_blk, A_blk, "cuda", gen_s, pack_s)
    p11 = block_multi(H_blk, A_blk, "cuda")
    del H_blk, A_blk
    fine = check_k6("cuda")
    rec_k6 = fine.pop("rec")
    p13 = grid_path(fine, "cuda")
    oo_gmg("cuda")
    p16 = gmres_ilut("cuda")
    p16b = gmres_jacobi_bws(p16, "cuda")
    p17 = pcg_ic("cuda")
    rec_k8 = check_k8(p16, p17, "cuda")
    del p17["Lc"]
    p18 = gmres_amg("cuda", p4["ms_per_iter"])
    direct("cuda")
    k4_p20, k8_p20 = block_gmres_ic("cuda")
    p21 = mixed_banded("cuda", p4, p5, p18)
    p22 = mixed_unstructured("cuda", path, num_levels=num_levels)
    p23_single, p23_multi = mixed_block("cuda", p10, p11)
    p24 = mixed_grid("cuda", p13)
    p13_counts = p13["counts"]
    del p13
    p25 = mixed_short("cuda")
    t27 = time.perf_counter()
    with no_twin_on_cuda():
        p27 = newton_small("cuda")
        p28 = newton_large("cuda")
        p29 = newton_krylov("cuda")
        p30 = multi_rhs("cuda")
    phase(30, f"phases 27-30 took {time.perf_counter() - t27:.1f} s")
    profile_unstructured(path, fine32, rec_bws)
    del path, fine32
    k1_p16, k8_p16 = p16["K1"], p16["K8"]
    profile_gmres_ilut(p16, "cuda")
    profile_ic(p17)
    del p16

    src = "pysolvers_tpu_torch/csrc/"
    print(json.dumps({"kernels": [
        dict(name="dia_spmv", route="cuda", source=src + "dia_spmv.cu",
             replaces="pysolvers_tpu/ops/spmv.py:197",
             launches=k1_launches, **rec_k1,
             path_launches={"phase 16": k1_p16, "phase 16b": p16b["K1"],
                            "phase 17": p17["K1"],
                            "phase 18 mgs": p18["mgs"]["K1"],
                            "phase 18 cgs2": p18["cgs2"]["K1"],
                            **mixed_path(p21, "K1"),
                            **mixed_path({"phase 24": p24,
                                          "phase 25": p25}, "K1"),
                            **mixed_path(p27, "K1"),
                            **mixed_path({"phase 28": p28}, "K1"),
                            **mixed_path(p29, "K1"),
                            **mixed_path(p30, "K1")}),
        dict(name="bws_spmv", route="cuda", source=src + "bws_spmv.cu",
             replaces="pysolvers_tpu/ops/bws_spmv.py:212",
             launches=counts["K2"], **rec_bws["K2"],
             path_launches={"phase 16b": p16b["K2"],
                            **mixed_path({"phase 22": p22}, "K2"),
                            **mixed_path(p30, "K2")}),
        # K3 serves bws_spmv_by_class, which no solve path calls: phase 7
        # checks that it made no launch there
        dict(name="bws_spmv_classes", route="cuda",
             source=src + "bws_spmv.cu",
             replaces="pysolvers_tpu/ops/bws_spmv.py:149",
             launches=counts["K3"], **rec_bws["K3"]),
        dict(name="lane_gather_probe", route="cuda",
             source=src + "lane_gather_probe.cu",
             replaces="benchmarks/probe_idx16.py:33",
             launches=rec_k7.pop("launches"), **rec_k7),
        dict(name="bdia_spmv", route="cuda", source=src + "bdia_spmv.cu",
             replaces="pysolvers_tpu/ops/spmv.py:308",
             launches=p10["launches"], **rec_bdia["K4"],
             path_launches={"phase 20 gmres": k4_p20,
                            **mixed_path({"phase 23 auto": p23_single},
                                         "K4")}),
        dict(name="bdia_spmm", route="cuda", source=src + "bdia_spmv.cu",
             replaces="pysolvers_tpu/ops/spmv.py:505",
             launches=p11["launches"], **rec_bdia["K5"],
             path_launches=mixed_path({"phase 23 k=8": p23_multi}, "K5")),
        dict(name="grid_dia_spmv", route="cuda",
             source=src + "grid_dia_spmv.cu",
             replaces="pysolvers_tpu/ops/grid_spmv.py:154",
             launches=p13_counts["K6"], **rec_k6,
             # phase 28's grids (m <= 1023) are below GRID_KERNEL_MIN_M:
             # flat DIA there, K1
             path_launches=mixed_path({"phase 24": p24,
                                       "phase 28": p28}, "K6")),
        # K8's own main path is phase 16 (two launches per ILUT apply); the
        # other paths that run it by dtype
        dict(name="block_trisolve", route="cuda",
             source=src + "block_trisolve.cu",
             replaces="pysolvers_tpu/ops/block_trisolve.py:349",
             launches=k8_p16["K8 f64"], **rec_k8,
             path_launches={**mixed_path({"phase 16": k8_p16,
                                          "phase 17": p17["K8"],
                                          "phase 20 ic": k8_p20,
                                          "phase 25": p25}, "K8"),
                            **mixed_path(p30, "K8")}),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
