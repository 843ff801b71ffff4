"""Helpers of the benchmark's own tests (run them with ``python -m pytest
solverbench/tests``; the repository's suite under ``tests/`` does not
collect them).  Not a conftest: on the card the tests run with
``--noconftest``, as the repository's root conftest imports JAX."""
import time

from solverbench.lib import loop, spec as S

# small sizes of the configurations' operators, for the CPU
SMALL_M = {"fd5_poisson_1M": 31, "fem_p1_poisson_1M": 33}


def small_run(cell: str, device: str = "cpu", seed: int = 2**31 + 11,
              seconds: float = 0.5, trace: bool = False, **kw):
    """One run of ``cell`` at a small size, every solve checked."""
    spec = S.load_spec()
    w = S.workload(spec, cell)
    cfg = S.config(spec, w["config"])
    cfg["operator"]["m"] = SMALL_M[w["config"]]
    mix = S.mix(w["traffic"])
    kw.setdefault("check_every", 1)
    return loop.run_cell(cfg, mix, seed, seconds, trace, device,
                         time.perf_counter(), **kw)
