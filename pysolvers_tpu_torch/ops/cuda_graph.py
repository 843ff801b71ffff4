"""A function of one device vector, served by replaying one CUDA graph.

``GraphedApply(fn, name, device)`` stands in for ``fn(v)``, a chain of
many small launches (the AMG preconditioner's V-cycles: the kernels' ctypes
launches, torch's elementwise and gather ops, a cuBLAS gemv), whose cost on
the card is mostly the host issuing them one at a time.  Per input
signature (shape, dtype and device of ``v``):

* the first call runs ``fn`` eagerly on the device's side stream, which
  makes the allocator's blocks, cuBLAS's workspace for that stream and the
  kernels' entry points before any capture, as torch asks of a capture;
* the second captures one call of ``fn`` on that stream into a
  ``torch.cuda.CUDAGraph``, reading a static input the object owns, and
  replays it;
* every later call copies ``v`` into the static input, replays the graph
  on the current stream and returns a clone of the static output: callers
  keep what they are handed (FGMRES's z_j, ``per_vector``'s columns), and
  the next replay overwrites the static output.

``fn`` must launch the same work for every input of a signature and make
no host read and no synchronising call: a replay repeats what the capture
launched, with the values it saw then.  The graph and its memory pool live
as long as the object.  A ``v`` that ``fn`` refuses (on another device,
say) raises in the eager first call, before any capture.

The kernel wrappers count a launch when they are called (their
``*_launches`` counters and ``_cuda_build.launches_by_dtype``), which a
replay does not do: each replay adds back what the capture counted, so
after any sequence of calls every counter reads what eager calls would
have counted.  ``Timer`` counters: "<name>.graph_captures", and
"<name>.graph_replays" for the calls served by a graph launch, the
capturing call included.
"""
from __future__ import annotations

import collections

import torch

from ..utils.timing import Timer
from . import _cuda_build, block_trisolve, bws_spmv, grid_spmv, probe, spmv

# the modules whose wrappers keep a module-level ``*_launches`` counter
_COUNTED_MODULES = (spmv, bws_spmv, grid_spmv, probe, block_trisolve)

# one side stream per device for every warm-up and capture: cuBLAS keeps a
# workspace per (handle, stream) for the life of the process
_SIDE_STREAMS: dict = {}


def launch_counts():
    """The wrappers' launch counts now: every ``*_launches`` counter by
    (module, name), and a copy of ``launches_by_dtype``."""
    counters = {(m, k): v for m in _COUNTED_MODULES
                for k, v in vars(m).items()
                if k.endswith("_launches") and isinstance(v, int)}
    return counters, collections.Counter(_cuda_build.launches_by_dtype)


def launches_since(before):
    """What the wrappers counted since ``launch_counts()`` gave
    ``before``, in its form."""
    counters, by_dtype = before
    now, now_by_dtype = launch_counts()
    return ({key: n - counters.get(key, 0) for key, n in now.items()
             if n != counters.get(key, 0)},
            now_by_dtype - by_dtype)


def add_launches(delta):
    """Count ``delta`` (from ``launches_since``) again, as its launches
    would have."""
    counters, by_dtype = delta
    for (module, name), n in counters.items():
        setattr(module, name, getattr(module, name) + n)
    _cuda_build.launches_by_dtype.update(by_dtype)


class _Graph:
    """One captured call of ``fn`` on ``stream``: the graph, its static
    input and output, and the launches the wrappers counted while it was
    captured."""

    def __init__(self, fn, v: torch.Tensor, stream: torch.cuda.Stream):
        current = torch.cuda.current_stream(v.device)
        self.static_in = torch.empty_like(
            v, memory_format=torch.contiguous_format)
        self.graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            self.graph.capture_begin()
            try:
                self.static_out = fn(self.static_in)
            finally:
                self.graph.capture_end()
        current.wait_stream(stream)
        self.launches = launches_since(before)

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        self.static_in.copy_(v)
        self.graph.replay()
        return self.static_out.clone()


class GraphedApply:
    """``fn`` of one CUDA vector, replayed as one CUDA graph per input
    signature from its second call on (module docstring)."""

    def __init__(self, fn, name: str, device):
        self.fn = fn
        self.name = name
        self.device = torch.device(device)
        self.stream = _SIDE_STREAMS.get(self.device)
        if self.stream is None:
            self.stream = _SIDE_STREAMS[self.device] = torch.cuda.Stream(
                self.device)
        self._warmed = set()
        self._graphs = {}

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        key = (tuple(v.shape), v.dtype, v.device)
        with torch.cuda.device(self.device):
            graph = self._graphs.get(key)
            if graph is None:
                if key not in self._warmed:
                    out = self._warm_up(v)
                    self._warmed.add(key)
                    return out
                graph = self._graphs[key] = _Graph(self.fn, v, self.stream)
                Timer.count(f"{self.name}.graph_captures")
            else:
                add_launches(graph.launches)
            Timer.count(f"{self.name}.graph_replays")
            return graph(v)

    def _warm_up(self, v: torch.Tensor) -> torch.Tensor:
        """``fn(v)`` eagerly on the side stream, ordered after the current
        stream's work and before its next."""
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = self.fn(v)
        current.wait_stream(self.stream)
        # made on the side stream, used on the current one: the allocator
        # must not hand its block out again before the current stream is done
        out.record_stream(current)
        return out
