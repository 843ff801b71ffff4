"""The JAX package's Newton steps and iteration counts for the calls of
``chip_smoke.py``'s phases 27-30 (Newton, Newton at m = 1023,
Newton-Krylov, ``solve(A, B)``), made in the JAX package's accelerator
mode, which is what the port runs on the card:

    JAX_PLATFORMS=cpu python tests/jax_newton_counts.py [phase ...]

On the CPU the JAX package picks "gs" for the AMG smoother and "level" for
ILU(t)/IC(t)'s "auto"; on its accelerator, and in the port on CUDA, they are
"jacobi" and "block".  This script patches the two choices
(``pysolvers_tpu.linear.amg.build_device_hierarchy``'s "auto" smoother and
``pysolvers_tpu.linear.ilu._resolve_trisolve_mode``) and runs each call as
chip_smoke.py makes it (f64; right-hand sides A x* with x* from
``default_rng(2)``).  The GMG hierarchy of phase 28 is built on the host
here and probed on the device there (the same Galerkin operators up to
rounding).  Prints one line per call; phases 27 and 29 take about five
minutes together, phase 30 about fifteen (its unrestarted mixed GMRES runs
three times, on B and on two draws of B moved by one f32 rounding).  Phase 28 is the full-size run (n = 1,046,529):
chip_smoke.py takes its Newton count, 3, from the JAX package's own
record of that call (benchmarks/our_results/bratu_large_r5.jsonl).
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import pysolvers_tpu as pst  # noqa: E402
from pysolvers_tpu.linear import amg as jamg  # noqa: E402
from pysolvers_tpu.linear import ilu as jilu  # noqa: E402
from pysolvers_tpu.linear import krylov as jkrylov  # noqa: E402
from pysolvers_tpu.linear.gmg import GMGPreconditionerType  # noqa: E402
from pysolvers_tpu.nonlinear.newton_krylov import (  # noqa: E402
    newton_krylov_solve)
from pysolvers_tpu.problems import Bratu2D  # noqa: E402
from pysolvers_tpu.problems.bratu import Bratu2DHostOuter  # noqa: E402
from pysolvers_tpu.problems.fem import (  # noqa: E402
    fem_poisson_2d_unstructured)
from pysolvers_tpu.problems.laplacian import fd_laplacian_2d  # noqa: E402

_resolve = jilu._resolve_trisolve_mode
jilu._resolve_trisolve_mode = lambda mode: "block" if mode == "auto" \
    else _resolve(mode)
_hierarchy = jamg.build_device_hierarchy


def _jacobi_hierarchy(mlh, smoother="auto", *args, **kwargs):
    return _hierarchy(mlh, "jacobi" if smoother == "auto" else smoother,
                      *args, **kwargs)


jamg.build_device_hierarchy = _jacobi_hierarchy


def _block_rhs(H, k=8):
    X = np.random.default_rng(2).random((k, H.shape[0]))
    return np.stack([H.matvec(x) for x in X], axis=1)


def _newton_1d():
    f2, d2 = (lambda x: x * x - 2.0), (lambda x: 2.0 * x)
    fa, da = np.arctan, (lambda x: 1.0 / (1.0 + x * x))
    out = {}
    for name, f, df, x0, maxiter in (("sqrt2", f2, d2, 1.0, 20),
                                     ("arctan", fa, da, 2.0, 50)):
        for ls in ("backtrack", "trivial"):
            search = (pst.SimpleBacktrack() if ls == "backtrack"
                      else pst.TrivialLinesearch())
            st = pst.NewtonSolver(pst.SolverConfig(maxiter=maxiter,
                                                   tau=1e-14),
                                  linesearch=search).solve(
                pst.FuncAdapter1D(f, df), jnp.asarray([x0]))
            out[f"{name} {ls}"] = (st.iters, st.reason.name)
    return out


def _bratu(m, precision):
    """examples/bratu_example.py: PCG + AMG(num_iters=5, num_levels=2)
    inside Newton, tau = 1e-12, min_lin_tol = 1e-6, freeze_prec."""
    inner = pst.PCG(pst.CommonSolverArgs(maxiter=500, tau=1e-12),
                    precond=pst.AMG(num_iters=5, num_levels=2),
                    precision=precision)
    st = pst.NewtonSolver(pst.SolverConfig(maxiter=30, tau=1e-12),
                          solver=inner, min_lin_tol=1e-6,
                          freeze_prec=True).solve(
        Bratu2D(m=m, alpha=0.5), jnp.zeros(m * m))
    return st.iters, st.reason.name


def _phase27():
    out = _newton_1d()
    for precision in ("native", "mixed"):
        out[f"bratu100 {precision}"] = _bratu(100, precision)
    return out


def _phase28(m=1023, levels=6):
    """benchmarks/bratu_large.py::run_ours at m = 1023."""
    prob = Bratu2DHostOuter(Bratu2D(m=m, alpha=0.5, fmt="dia"))
    inner = pst.PCG(pst.CommonSolverArgs(maxiter=400, tau=1e-12),
                    precond=GMGPreconditionerType(
                        dims=(m, m), num_iters=2, num_levels=levels,
                        smoother="jacobi"),
                    precision="mixed")
    st = pst.NewtonSolver(pst.SolverConfig(maxiter=30, tau=1e-12),
                          solver=inner, min_lin_tol=1e-6,
                          freeze_prec=True).solve(
        prob, np.ones(prob.n, dtype=np.longdouble))
    return {f"bratu{m} host-outer mixed GMG{levels}": (st.iters,
                                                       st.reason.name)}


def _phase29(ms=(63, 127, 255)):
    """tests/test_newton_krylov.py's settings, matrix-free and with the
    explicit Jacobian and its Jacobi preconditioner."""
    out = {}
    for m in ms:
        prob = Bratu2D(m=m)
        x0 = jnp.zeros(prob.n)
        _, st = newton_krylov_solve(prob.eval_f, x0, tau=1e-12, maxiter=30,
                                    inner_maxiter=300, method="cg",
                                    min_lin_tol=1e-8)
        out[f"m={m} jvp"] = (int(st.k), int(st.inner_total),
                             pst.StopReason(int(st.reason)).name)
        _, st = newton_krylov_solve(prob.eval_f, x0, tau=1e-12, maxiter=30,
                                    inner_maxiter=500, method="cg",
                                    min_lin_tol=1e-8,
                                    eval_j=prob.eval_j_dev,
                                    precond_from_j=prob.jacobi_precond)
        out[f"m={m} explicit J + Jacobi"] = (
            int(st.k), int(st.inner_total),
            pst.StopReason(int(st.reason)).name)
    return out


def _f32_passes():
    """Wraps the JAX package's ``gmres_solve_multi`` so that each f32 call
    (one refinement pass of solve()'s mixed GMRES) appends its per-column
    iterations to the returned list."""
    passes = []
    real = jkrylov.gmres_solve_multi

    def logged(*args, **kwargs):
        X, st, hist = real(*args, **kwargs)
        if args[1].dtype == jnp.float32:
            jax.debug.callback(
                lambda k: passes.append(tuple(int(v) for v in k)), st.k)
        return X, st, hist
    jkrylov.gmres_solve_multi = logged
    return passes


def _phase30():
    """solve(A, B) with k = 8 on fd_laplacian_2d(150), tau = 1e-10.  The
    unrestarted mixed GMRES also on B moved by one f32 rounding (two
    draws): its total moves by whole refinement passes of 1000 steps."""
    H = fd_laplacian_2d(150)
    B = _block_rhs(H)
    passes = _f32_passes()
    out = {}
    for name, kw in (("cg", dict(method="cg")),
                     ("gmres", dict(method="gmres")),
                     ("cg mixed", dict(method="cg", precision="mixed")),
                     ("gmres mixed", dict(method="gmres",
                                          precision="mixed")),
                     ("gmres mixed restart=60", dict(
                         method="gmres", precision="mixed", restart=60)),
                     ("gmres cgs2", dict(method="gmres", orthog="cgs2"))):
        passes.clear()
        st = pst.solve(H, B, tau=1e-10, **kw)
        out[name] = (st.iters, st.reason.name)
        if name == "gmres mixed":
            out[name + " passes"] = list(passes)
    for draw in (1, 2):
        Bd = B * (1 + 6e-8 * np.random.default_rng(100 + draw)
                  .standard_normal(B.shape))
        passes.clear()
        st = pst.solve(H, Bd, tau=1e-10, method="gmres", precision="mixed")
        out[f"gmres mixed, B draw {draw}"] = (st.iters, st.reason.name,
                                             list(passes))
    Hd = fd_laplacian_2d(22)
    st = pst.solve(Hd, _block_rhs(Hd), tau=1e-10, method="direct")
    out["direct n=484"] = (st.iters, st.reason.name)
    Hf = fem_poisson_2d_unstructured(151, seed=3)
    st = pst.solve(Hf, _block_rhs(Hf), tau=1e-10, method="cg",
                   precond="jacobi", precision="mixed")
    out[f"fem n={Hf.shape[0]} cg jacobi mixed"] = (st.iters,
                                                  st.reason.name)
    return out


PHASES = {"27": _phase27, "28": _phase28, "29": _phase29, "30": _phase30}


def main(phases):
    for ph in phases:
        jilu._SCALE_CACHE.clear()
        t0 = time.perf_counter()
        for name, counts in PHASES[ph]().items():
            print(f"phase {ph} {name}: {counts}", flush=True)
        print(f"phase {ph}: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or sorted(PHASES))
