"""How far the mixed-precision multi-RHS counts of the JAX package and of
the port move when B moves by one f32 rounding, on the CPU:

    JAX_PLATFORMS=cpu python tests/mixed_count_spread.py amg
    JAX_PLATFORMS=cpu python tests/mixed_count_spread.py gmres

``amg``: ``solve(A, B, method="cg", precond="amg", precision="mixed")``
(lockstep CG with f64 residual replacement, AMG(2, 2) in f32) on
``fd_laplacian_2d(m)``, m = 16, 24, 31, k = 3 right-hand sides A x* with x*
from ``default_rng(seed)``, seeds 4, 5, 6; per column, the iterations on B
and on five draws B (1 + 6e-8 N(0, 1)), in both packages, with the CPU's
"gs" smoother and with "jacobi" (the accelerator's).  About twenty
minutes.

``gmres``: the port with ``device="cpu"`` on ``chip_smoke.py``'s phase 30
call ``solve(fd_laplacian_2d(150), B, method="gmres", precision="mixed")``
(no restart; ILUT applied by block solves, K8's twin) after the native
GMRES that fills the drop-scale cache, as on the card; the per-column
iterations of each refinement pass.  The JAX package's numbers for the same
call are ``tests/jax_newton_counts.py 30``'s.  About twenty minutes.

Not collected by pytest.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import pysolvers_tpu as pst  # noqa: E402
import pysolvers_tpu_torch as pt  # noqa: E402
from pysolvers_tpu.linear import amg as jamg  # noqa: E402
from pysolvers_tpu.linear import krylov as jkrylov  # noqa: E402
from pysolvers_tpu.problems import laplacian as jlap  # noqa: E402
from pysolvers_tpu_torch.linear import amg as tamg  # noqa: E402
from pysolvers_tpu_torch.linear import ilu as tilu  # noqa: E402

TSOLVE = sys.modules["pysolvers_tpu_torch.solve"]


def _record_k(jax_mod, torch_mod, name):
    """Wraps ``name`` in both packages so that each call appends its
    per-column iterations to the returned lists (JAX's, the port's)."""
    jrec, trec = [], []
    jreal, treal = getattr(jax_mod, name), getattr(torch_mod, name)

    def jwrap(*args, **kwargs):
        X, st, hist = jreal(*args, **kwargs)
        jax.debug.callback(lambda k: jrec.append(np.asarray(k).tolist()),
                           st.k)
        return X, st, hist

    def twrap(*args, **kwargs):
        X, st, hist = treal(*args, **kwargs)
        trec.append(st.k.tolist())
        return X, st, hist
    setattr(jax_mod, name, jwrap)
    setattr(torch_mod, name, twrap)
    return jrec, trec


def amg_spread(draws=5):
    jrec, trec = _record_k(jkrylov, TSOLVE, "cg_lockstep_rr")
    real = {mod: mod.build_device_hierarchy for mod in (jamg, tamg)}
    kw = dict(tau=1e-10, method="cg", precond="amg", precision="mixed")
    for smoother in ("gs", "jacobi"):
        for mod in (jamg, tamg):
            mod.build_device_hierarchy = (
                lambda mlh, sm="auto", *a, _r=real[mod], **k: _r(
                    mlh, smoother if sm == "auto" else sm, *a, **k))
        for m in (16, 24, 31):
            Hj, Ht = jlap.fd_laplacian_2d(m), pt.problems.fd_laplacian_2d(m)
            for seed in (4, 5, 6):
                X = np.random.default_rng(seed).random((3, Hj.shape[0]))
                B0 = np.stack([Hj.matvec(c) for c in X], axis=1)
                row = dict(smoother=smoother, m=m, seed=seed, jax=[],
                           port=[])
                for d in range(draws + 1):
                    B = B0 if d == 0 else B0 * (
                        1 + 6e-8 * np.random.default_rng(100 + d)
                        .standard_normal(B0.shape))
                    pst.solve(Hj, B, **kw)
                    pt.solve(Ht, B, device="cpu", **kw)
                    row["jax"].append(jrec[-1])
                    row["port"].append(trec[-1])
                print(json.dumps(row), flush=True)


def gmres_port_cpu():
    torch.set_num_threads(4)
    resolve = tilu._resolve_trisolve_mode
    tilu._resolve_trisolve_mode = (
        lambda mode, device=None: "block" if mode == "auto"
        else resolve(mode, device))
    real = TSOLVE.gmres_solve_multi
    passes = []

    def logged(mm, R, **kwargs):
        X, st, hist = real(mm, R, **kwargs)
        if R.dtype == torch.float32:
            passes.append(st.k.tolist())
        return X, st, hist
    TSOLVE.gmres_solve_multi = logged
    H = pt.problems.fd_laplacian_2d(150)
    X = np.random.default_rng(2).random((8, H.shape[0]))
    B = np.stack([H.matvec(x) for x in X], axis=1)
    for kw in (dict(method="gmres"),
               dict(method="gmres", precision="mixed")):
        passes.clear()
        st = pt.solve(H, B, tau=1e-10, device="cpu", **kw)
        print(json.dumps(dict(call=kw, iters=st.iters,
                              reason=st.reason.name, passes=passes)),
              flush=True)


if __name__ == "__main__":
    {"amg": amg_spread, "gmres": gmres_port_cpu}[sys.argv[1]]()
