"""Kernel K7: the narrow-lane-index probe (``csrc/lane_gather_probe.cu``).

Port of ``benchmarks/probe_idx16.py``.  It answers one hardware question
for the BWS kernels: do int16 lane indices, loaded and widened to int32
inside a kernel, gather the right values?  (On the TPU, int8 indices did
not, so the JAX package kept int32 lane indices.)

* ``lane_gather_probe(idx, x)`` — the wrapper: out[r, l] = x[r, idx[r, l]]
  for an (rows, 128) int16 index table and float32 x.  A CPU tensor is
  range-checked and goes to the twin; a CUDA tensor launches K7 or raises,
  and nothing else: one launch, no host round trip.  K7 checks the range
  on each lane itself; a lane outside [0, 128) reads nothing, yields 0 and
  sets the device's out-of-range flag, which this module owns.
* ``check_lane_indices(device)`` — reads and clears that flag (a host
  sync), raising ValueError if it was set: call it where the host reads
  the result anyway.
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
# (1,) int32 out-of-range flag per CUDA device, set by K7, cleared by
# check_lane_indices
_BAD_LANES: dict = {}


def lane_gather_probe_torch(idx: torch.Tensor, x: torch.Tensor
                            ) -> torch.Tensor:
    return torch.gather(x, 1, idx.to(torch.int64))


def _entry():
    global _ENTRY
    if _ENTRY is None:
        fn = _cuda_build.load("lane_gather_probe").lane_gather_probe
        fn.argtypes = ([ctypes.c_void_p] * 4
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _ENTRY = fn
    return _ENTRY


def _bad_lanes(index: int) -> torch.Tensor:
    """The out-of-range flag of CUDA device ``index``, made at first use."""
    flag = _BAD_LANES.get(index)
    if flag is None:
        flag = _BAD_LANES[index] = torch.zeros(
            1, dtype=torch.int32, device=torch.device("cuda", index))
    return flag


def check_lane_indices(device) -> None:
    """Raise ValueError if a K7 launch on ``device`` since the last check
    met a lane index outside [0, 128); clears the flag.  Reads it back, so
    it waits for those launches."""
    device = torch.device(device)
    flag = _BAD_LANES.get(device.index if device.index is not None
                          else torch.cuda.current_device())
    if flag is None:
        return
    bad = int(flag.item())
    flag.zero_()
    if bad:
        raise ValueError("lane indices must lie in [0, 128): a K7 launch met "
                         "one outside (those lanes gathered nothing)")


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
        if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= 128):
            raise ValueError("lane indices must lie in [0, 128)")
        return lane_gather_probe_torch(idx, x)
    if x.device.type != "cuda":
        raise ValueError(f"the probe runs on CPU or CUDA, not {x.device}")
    idx, x = idx.contiguous(), x.contiguous()
    out = torch.empty_like(x)
    dev = x.device.index
    # a one-tile call is all host time: K7 switches to x's device itself,
    # and the raw stream handle (the lookup torch's generated kernels use)
    # spares a device context and a Stream object per call
    rc = _entry()(idx.data_ptr(), x.data_ptr(), out.data_ptr(),
                  _bad_lanes(dev).data_ptr(), idx.shape[0], dev,
                  torch._C._cuda_getCurrentRawStream(dev))
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
    if torch.device(device).type == "cuda":
        check_lane_indices(device)
    want = np.take_along_axis(x, idx.astype(np.int64), axis=1)
    return float(np.abs(out.cpu().numpy() - want).max())
