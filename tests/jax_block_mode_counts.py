"""The JAX package's iteration counts with ILU(t)/IC(t) applied by its exact
block-banded triangular solves, the mode its "auto" takes on the
accelerator: the gates of ``chip_smoke.py``'s phases 16, 17, 20 and 25,
where the port's "auto" runs kernel K8 on the card.

    JAX_PLATFORMS=cpu python tests/jax_block_mode_counts.py [phase ...]

On the CPU the JAX package's "auto" is "level"; this script patches
``pysolvers_tpu.linear.ilu._resolve_trisolve_mode`` so that "auto" gives
"block" (the fill-budget search of ``drop_scale="auto"`` runs with it, as
on the accelerator), and runs each phase's call as chip_smoke.py makes it:
f64, tau = 1e-10, b = A x* with x* from ``default_rng(2)``.  Prints one
line per phase.  Phase 16 (n = 65,025, full GMRES) takes minutes.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

import pysolvers_tpu as pst  # noqa: E402
from pysolvers_tpu.linear import ilu as jilu  # noqa: E402
from pysolvers_tpu.problems.laplacian import (  # noqa: E402
    fd_convection_diffusion_2d, fd_vector_laplacian_2d)

_real = jilu._resolve_trisolve_mode
jilu._resolve_trisolve_mode = lambda mode: "block" if mode == "auto" \
    else _real(mode)


def _rhs(H):
    x_star = np.random.default_rng(2).random(H.shape[0])
    return H.matvec(x_star)


PHASES = {
    "16": lambda: pst.solve(H := fd_convection_diffusion_2d(255), _rhs(H),
                            tau=1e-10),
    "17": lambda: pst.solve(H := pst.problems.fd_laplacian_2d(129), _rhs(H),
                            tau=1e-10),
    "20": lambda: pst.solve(
        pst.BdiaMatrix.from_host_csr(
            H := fd_vector_laplacian_2d(64, b=5, coupling=0.2), 5),
        _rhs(H), tau=1e-10, method="auto", precond="ic"),
    "25": lambda: pst.solve(H := fd_convection_diffusion_2d(63), _rhs(H),
                            tau=1e-10, precision="mixed"),
}


def main(phases):
    for ph in phases:
        jilu._SCALE_CACHE.clear()
        t0 = time.perf_counter()
        st = PHASES[ph]()
        print(f"phase {ph}: iters={st.iters} reason={st.reason.name} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or sorted(PHASES, key=int, reverse=True))
