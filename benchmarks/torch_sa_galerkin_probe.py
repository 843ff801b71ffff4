"""Probe the port's host SA Galerkin stage: the native passes against the
numpy route.  Imports the port only (no jax).

    python3 benchmarks/torch_sa_galerkin_probe.py equal [--m 1025]
        Host SA hierarchies of the unstructured FEM (m, mesh seed 3, RCM
        order) and of fd5 (m - 2), built once with the native passes and
        once on the numpy route, twice each: whether every P, R and A of
        every level is bit-equal, the timers "amg.aggregate",
        "amg.galerkin" and "amg.rap", and level 0's sub-steps (the P pass,
        the transpose, A·P, R·(AP)).

    python3 benchmarks/torch_sa_galerkin_probe.py heap [--m 1023]
        fd5 fresh-Jacobian solves (PCG + AMG(2, 6), a new diagonal shift
        each solve) in one process, five blocks of five, the native and
        the numpy route in turns; per solve the wall time and the timers
        "api.as_device_matrix", "amg.device_lower", "amg.galerkin",
        "amg.rap", then each route's medians.  Run it twice, the second
        time with glibc told to keep freed memory, to see how much of the
        lowering's time depends on the heap the builds leave behind:

        MALLOC_MMAP_THRESHOLD_=33554432 MALLOC_TRIM_THRESHOLD_=4294967296 \\
        MALLOC_TOP_PAD_=268435456 \\
            python3 benchmarks/torch_sa_galerkin_probe.py heap

One JSON line per build or solve; the card is used where CUDA is present.
"""
import argparse
import json
import statistics
import time

import numpy as np
import torch

import pysolvers_tpu_torch as pt
import pysolvers_tpu_torch.linear.amg as tamg
from pysolvers_tpu_torch.sparse.bws import BwsMatrix
from pysolvers_tpu_torch.sparse.host import HostCSR
from pysolvers_tpu_torch.utils import native
from pysolvers_tpu_torch.utils.timing import Timer

TOL = 0.08
_PASSES = native.sa_prolongator, native.csr_transpose


def use_route(route):
    """"native": the two passes; "numpy": both left to the numpy route."""
    if route == "native":
        native.sa_prolongator, native.csr_transpose = _PASSES
    else:
        native.sa_prolongator = lambda *a, **k: None
        native.csr_transpose = lambda *a, **k: None


def same(X, Y):
    return (np.array_equal(X.indptr, Y.indptr)
            and np.array_equal(X.indices, Y.indices)
            and np.array_equal(X.data.view(np.uint8), Y.data.view(np.uint8)))


def build(A, levels, route):
    use_route(route)
    Timer.reset()
    t0 = time.perf_counter()
    h = tamg.build_sa_hierarchy(A, levels)
    wall = time.perf_counter() - t0
    use_route("native")
    return h, dict(wall=wall, **{k: Timer.total(k) for k in
                                 ("amg.aggregate", "amg.galerkin", "amg.rap")},
                   native_levels=Timer.calls("amg.native_galerkin_levels"),
                   levels=Timer.calls("amg.galerkin_levels"))


def equal(m):
    F = pt.problems.fem_poisson_2d_unstructured(m, seed=3)
    cases = {"fem": (F.permute_symmetric(BwsMatrix._rcm_perm(F)), 4),
             "fd5": (pt.problems.fd_laplacian_2d(m - 2), 6)}
    print(json.dumps(dict(setup_lib=native.get_setup_lib() is not None)),
          flush=True)
    for name, (A, levels) in cases.items():
        for rep in range(2):
            hn, tn = build(A, levels, "native")
            hp, tp = build(A, levels, "numpy")
            mats = zip(hn.matrices + hn.prolongators + hn.restrictions,
                       hp.matrices + hp.prolongators + hp.restrictions)
            print(json.dumps(dict(case=name, n=A.n_rows, rep=rep,
                                  bit_equal=all(same(X, Y) for X, Y in mats),
                                  native=tn, numpy=tp)), flush=True)
        s = tamg.strength_neighbors(A, TOL)
        agg = tamg.build_aggregates(A, TOL, strength=s)
        t0 = time.perf_counter()
        P, native_p = tamg.smoothed_prolongator(A, TOL, s, agg)
        t1 = time.perf_counter()
        R = P.transpose()
        t2 = time.perf_counter()
        AP = A.matmat(P)
        t3 = time.perf_counter()
        R.matmat(AP)
        t4 = time.perf_counter()
        print(json.dumps(dict(case=name, level0=dict(
            native=native_p, p_pass=t1 - t0, transpose=t2 - t1, a_p=t3 - t2,
            r_ap=t4 - t3, nnz=A.nnz, p_nnz=P.nnz))), flush=True)


def heap(m):
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    A = pt.problems.fd_laplacian_2d(m)
    rows, cols, _ = A.to_coo()
    diag = np.flatnonzero(rows == cols)
    rng = np.random.default_rng(5)
    solver = pt.PCG(pt.CommonSolverArgs(maxiter=500, tau=1e-10),
                    precond=pt.AMG(num_iters=2, num_levels=6, nu_pre=2,
                                   nu_post=2, galerkin="auto",
                                   matrix_format="auto"),
                    device=dev).make_solver()
    keys = ("api.as_device_matrix", "amg.device_lower", "amg.galerkin",
            "amg.rap", "amg.device_aggregate", "amg.aggregate")
    out = {}
    for block, route in enumerate(["native", "numpy"] * 2 + ["native"]):
        use_route(route)
        for k in range(5):
            J = HostCSR(A.indptr, A.indices, A.data.copy(), A.shape)
            J.data[diag] += 0.5 * np.exp(-rng.random(A.shape[0]))
            b = torch.from_numpy(J.matvec(rng.random(A.shape[0]))).to(dev)
            Timer.reset()
            if dev == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = solver.solve(J, b)
            if dev == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if k == 0:
                continue        # its heap is the other route's
            rec = dict(wall=wall, iters=int(st.iters),
                       **{t: Timer.total(t) for t in keys})
            out.setdefault(route, []).append(rec)
            print(json.dumps(dict(block=block, route=route, k=k, **rec)),
                  flush=True)
    use_route("native")
    for route, recs in out.items():
        print(json.dumps(dict(route=route, medians={
            t: statistics.median(r[t] for r in recs)
            for t in ("wall",) + keys})), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("part", choices=("equal", "heap"))
    ap.add_argument("--m", type=int, default=None,
                    help="grid size (equal: FEM m, default 1025; "
                         "heap: fd5 m, default 1023)")
    a = ap.parse_args()
    if a.part == "equal":
        equal(a.m or 1025)
    else:
        heap(a.m or 1023)


if __name__ == "__main__":
    main()
