"""Kernel K7: the narrow-lane-index probe (``csrc/lane_gather_probe.cu``).

Port of ``benchmarks/probe_idx16.py``.  It answers one hardware question
for the BWS kernels: do int16 lane indices, loaded and widened to int32
inside a kernel, gather the right values?  (On the TPU, int8 indices did
not, so the JAX package kept int32 lane indices.)

* ``lane_gather_probe(idx, x)`` — the wrapper: out[r, l] = x[r, idx[r, l]]
  for an (rows, 128) int16 index table and float32 x.  A CPU tensor goes
  to the twin; a CUDA tensor launches K7 or raises.
* ``lane_gather_probe_torch`` — the plain twin (``torch.gather`` on the
  indices widened to int64).
* ``probe_main(device)`` — the probe script's run: the same seeded inputs,
  checked against numpy.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _cuda_build

# Launches of K7 since the last reset (added to only where K7 launches).
lane_gather_probe_launches = 0

_ENTRY = None


def lane_gather_probe_torch(idx: torch.Tensor, x: torch.Tensor
                            ) -> torch.Tensor:
    return torch.gather(x, 1, idx.to(torch.int64))


def _entry():
    global _ENTRY
    if _ENTRY is None:
        fn = _cuda_build.load("lane_gather_probe").lane_gather_probe
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _ENTRY = fn
    return _ENTRY


def lane_gather_probe(idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out[r, l] = x[r, idx[r, l]]: K7 on CUDA, its twin on the CPU."""
    global lane_gather_probe_launches
    if idx.dtype != torch.int16 or x.dtype != torch.float32:
        raise TypeError(f"the probe takes int16 indices and float32 x, got "
                        f"{idx.dtype} and {x.dtype}")
    if idx.ndim != 2 or idx.shape[1] != 128 or x.shape != idx.shape:
        raise ValueError(f"the probe takes (rows, 128) tables, got "
                         f"{tuple(idx.shape)} and {tuple(x.shape)}")
    if idx.device != x.device:
        raise ValueError(f"idx is on {idx.device}, x on {x.device}")
    if x.device.type == "cpu":
        return lane_gather_probe_torch(idx, x)
    if x.device.type != "cuda":
        raise ValueError(f"the probe runs on CPU or CUDA, not {x.device}")
    if int(idx.min()) < 0 or int(idx.max()) >= 128:
        raise ValueError("lane indices must lie in [0, 128)")
    idx, x = idx.contiguous(), x.contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _entry()(idx.data_ptr(), x.data_ptr(), out.data_ptr(),
                      idx.shape[0], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K7 (lane_gather_probe) launch failed: CUDA "
                           f"error {rc}")
    lane_gather_probe_launches += 1
    return out


def probe_main(device) -> float:
    """``benchmarks/probe_idx16.py``'s run on ``device``: x (8, 128) f32 and
    idx (8, 128) int16 from ``default_rng(0)``; returns max|out - numpy|,
    0.0 when int16 lane indices gather correctly."""
    rng = np.random.default_rng(0)
    x = rng.random((8, 128)).astype(np.float32)
    idx = rng.integers(0, 128, size=(8, 128)).astype(np.int16)
    out = lane_gather_probe(torch.from_numpy(idx).to(device),
                            torch.from_numpy(x).to(device))
    want = np.take_along_axis(x, idx.astype(np.int64), axis=1)
    return float(np.abs(out.cpu().numpy() - want).max())
