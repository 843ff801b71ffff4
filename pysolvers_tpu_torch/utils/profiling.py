"""Profiling and performance accounting.

Port of ``pysolvers_tpu/utils/profiling.py``:

* ``trace(...)`` — a context manager around ``torch.profiler`` that writes
  a Chrome trace (``trace.json``) into a directory;
* ``SpeedOfLight`` — roofline accounting: a kernel's bytes and operations
  against the card's memory rate and peak, as the time it cannot beat and
  the share of it that a measured time reaches;
* ``measure(fn, *args)`` — best-of time per call, by CUDA events where
  the card is there (``torch.cuda.synchronize`` before and after), by the
  host clock on the CPU.

The rates are the NVIDIA H100 SXM data sheet's (at 700 W): HBM3 at
3.35 TB/s, 67 TFLOP/s in f32 and 34 TFLOP/s in f64 outside the tensor
cores, the card the port targets (``chip_smoke.py`` uses the same).  The
JAX package's table of TPU generations is not ported.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    hbm_gbps: float          # memory rate, GB/s
    f32_tflops: float        # peak f32 TFLOP/s (no tensor cores)
    f64_tflops: float        # peak f64 TFLOP/s (no tensor cores)


CHIPS = {
    "h100-sxm": ChipSpec("NVIDIA H100 SXM (data sheet)", 3350.0, 67.0, 34.0),
}


def current_chip() -> ChipSpec:
    """The data-sheet rates of the card the port targets.  A card that is
    set below 700 W runs slower under load; its name and power limit come
    from ``nvidia-smi``, not from here."""
    return CHIPS["h100-sxm"]


@dataclasses.dataclass
class SpeedOfLight:
    """Roofline accounting for one kernel invocation; ``flops`` at the
    peak of ``dtype`` ("float32" or "float64")."""

    bytes_moved: float
    flops: float = 0.0
    chip: Optional[ChipSpec] = None
    dtype: str = "float32"

    def _times(self):
        c = self.chip or current_chip()
        peak = c.f64_tflops if self.dtype == "float64" else c.f32_tflops
        return self.bytes_moved / (c.hbm_gbps * 1e9), self.flops / (peak
                                                                    * 1e12)

    def bound(self) -> str:
        t_mem, t_flop = self._times()
        return "memory" if t_mem >= t_flop else "compute"

    def sol_seconds(self) -> float:
        return max(self._times())

    def achieved_fraction(self, measured_s: float) -> float:
        return self.sol_seconds() / measured_s if measured_s > 0 else 0.0


def measure(fn: Callable, *args, warmup: int = 2, repeats: int = 20,
            inner: int = 5) -> float:
    """Best-of seconds per call of ``fn(*args)`` over ``repeats`` runs of
    ``inner`` calls each, after ``warmup`` calls."""
    cuda = torch.cuda.is_available()
    for _ in range(warmup):
        fn(*args)
    if cuda:
        torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn(*args)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(inner):
                fn(*args)
            dt = time.perf_counter() - t0
        best = min(best, dt / inner)
    return best


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """``torch.profiler`` trace of the block (CPU and, where the card is
    there, CUDA activity), written as ``<log_dir>/trace.json`` (Chrome
    trace format; without ``log_dir``, a new directory under the
    temporary directory each call).  Yields the directory.  The trace
    holds the program's spans (``utils.timing``: "krylov.*", "amg.*")
    beside the kernels and copies they launched, on one clock."""
    from torch.profiler import ProfilerActivity, profile
    if not log_dir:
        log_dir = tempfile.mkdtemp(prefix="pst_trace_")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def spmv_sol(nnz: int, n: int, fmt: str, dtype_bytes: int = 4,
             n_diags: int = 0) -> SpeedOfLight:
    """Speed-of-light model for one SpMV by storage format."""
    if fmt == "dia":
        bytes_moved = (n_diags * n + 2 * n) * dtype_bytes
    elif fmt == "ell":
        bytes_moved = nnz * (dtype_bytes + 4) + 2 * n * dtype_bytes
    else:  # csr
        bytes_moved = nnz * (dtype_bytes + 4) + (3 * n) * dtype_bytes
    return SpeedOfLight(bytes_moved=float(bytes_moved), flops=2.0 * nnz,
                        dtype="float64" if dtype_bytes == 8 else "float32")
