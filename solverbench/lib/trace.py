"""The traced part of a ``--trace 1`` window, and its reduction.

``Tracer`` runs ``torch.profiler`` (CPU and CUDA activity) over the first
solves of the window, inside one user annotation, ``WINDOW``, that fixes
the traced window on the profiler's clock; each solve is annotated
``SOLVE``.  ``reduce`` turns the raw events into a ``TraceSummary``: the
device intervals (kernels, copies, sets) clipped to the window, their
union (``busy_s``), the kernels by name, and the idle gaps, each named by
the innermost host operation that was running at its middle.  The raw
kineto events are read directly: ``key_averages`` costs too much per event
for a window of 10^5 launches.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import List, Optional, Tuple

import numpy as np

WINDOW = "solverbench.traced_window"
SOLVE = "solverbench.solve"
_COPIES = ("Memcpy", "Memset")


@dataclasses.dataclass
class TraceSummary:
    window_s: float                  # the traced window, host clock
    busy_s: float                    # union of device intervals in it
    kernel_names: List[str]          # every kernel in the window
    kernel_s: np.ndarray             # and its duration, seconds
    device_ops: List[Tuple[str, float]]    # seconds by name, largest first
    idle_gaps: List[Tuple[str, float]]     # idle seconds by host op

    @property
    def idle_share(self) -> float:
        return max(0.0, 1.0 - self.busy_s / self.window_s)


def union_length(starts: np.ndarray, ends: np.ndarray) -> float:
    """Length of the union of the intervals [starts[i], ends[i])."""
    return float(sum(e - s for s, e in _merged(starts, ends)))


def _merged(starts, ends):
    """The union of the intervals as a list of disjoint (start, end)."""
    if len(starts) == 0:
        return []
    order = np.argsort(starts, kind="stable")
    s = np.asarray(starts, dtype=np.float64)[order]
    e = np.maximum.accumulate(np.asarray(ends, dtype=np.float64)[order])
    new = np.ones(len(s), dtype=bool)
    new[1:] = s[1:] > e[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:] - 1, len(s) - 1)
    return list(zip(s[first], e[last]))


def idle_gaps(lo: float, hi: float, starts, ends) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi) that no interval covers."""
    gaps, t = [], lo
    for s, e in _merged(starts, ends):
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
    if t < hi:
        gaps.append((t, hi))
    return [(a, b) for a, b in gaps if b > a]


def name_gaps(gaps, cpu_starts, cpu_ends, cpu_names, top: int = 10):
    """Idle seconds summed by the innermost host op that covers each gap's
    middle ("(no host op)" where none does), largest first: one sweep in
    time order with a stack of the open ops, whose top is the innermost."""
    order = np.argsort(cpu_starts, kind="stable")
    cs = np.asarray(cpu_starts, dtype=np.float64)[order]
    ce = np.asarray(cpu_ends, dtype=np.float64)[order]
    names = [cpu_names[i] for i in order]
    by = collections.Counter()
    stack, j = [], 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (a + b)
        while j < len(cs) and cs[j] <= mid:
            while stack and ce[stack[-1]] < cs[j]:
                stack.pop()
            stack.append(j)
            j += 1
        while stack and ce[stack[-1]] < mid:
            stack.pop()
        by[names[stack[-1]] if stack else "(no host op)"] += b - a
    return [(k, float(v)) for k, v in by.most_common(top)]


class Tracer:
    """The profiler over part of a window (a no-op when ``on`` is
    false)."""

    def __init__(self, on: bool, device: str):
        self.on = on
        self.cuda = device.startswith("cuda")
        self.prof = None
        self._window = None

    def _activities(self):
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        return acts

    def warm(self):
        """One short profile in set-up, so that the tracer's own first
        start (CUPTI's) falls outside the window."""
        if not self.on:
            return
        import torch
        from torch.profiler import profile
        with profile(activities=self._activities()):
            torch.ones(8, device="cuda" if self.cuda else "cpu").sum()
            self._sync()

    def _sync(self):
        if self.cuda:
            import torch
            torch.cuda.synchronize()

    def start(self):
        from torch.autograd.profiler import record_function
        from torch.profiler import profile
        self._sync()
        self.prof = profile(activities=self._activities())
        self.prof.__enter__()
        self._window = record_function(WINDOW)
        self._window.__enter__()

    def stop(self):
        self._sync()
        self._window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    @staticmethod
    def span(name: str):
        """An annotation of the trace (while the profiler runs)."""
        from torch.autograd.profiler import record_function
        return record_function(name)

    def reduce(self, top: int = 10) -> Optional[TraceSummary]:
        if self.prof is None:
            return None
        from torch.autograd import DeviceType
        dev, cpu = [], []
        window = None
        for e in self.prof.profiler.kineto_results.events():
            span = (e.name(), e.start_ns(), e.end_ns())
            if e.device_type() == DeviceType.CPU:
                if e.name() == WINDOW:
                    window = span
                cpu.append(span)
            elif not e.is_user_annotation():
                dev.append(span)
        if window is None:
            return None
        # seconds from the window's start: absolute nanoseconds in a
        # float64 would round a microsecond kernel
        _, base, end = window
        lo, hi = 0.0, (end - base) * 1e-9

        def rel(spans):
            return [(n, (s - base) * 1e-9, (e - base) * 1e-9)
                    for n, s, e in spans]
        dev, cpu = rel(dev), rel(cpu)
        dev = [(n, max(s, lo), min(e, hi)) for n, s, e in dev
               if e > lo and s < hi]
        starts = np.array([s for _, s, _ in dev])
        ends = np.array([e for _, _, e in dev])
        by_name = collections.Counter()
        for n, s, e in dev:
            by_name[n] += e - s
        kernels = [(n, e - s) for n, s, e in dev if not n.startswith(_COPIES)]
        cpu = [c for c in cpu if c[0] != WINDOW and c[2] > lo and c[1] < hi]
        gaps = idle_gaps(lo, hi, starts, ends)
        return TraceSummary(
            window_s=hi - lo, busy_s=union_length(starts, ends),
            kernel_names=[n for n, _ in kernels],
            kernel_s=np.array([d for _, d in kernels], dtype=np.float64),
            device_ops=[(n, float(v)) for n, v in by_name.most_common(top)],
            idle_gaps=name_gaps(gaps, [c[1] for c in cpu],
                                [c[2] for c in cpu], [c[0] for c in cpu],
                                top))


def idle_percent(run):
    """The idle share of a run's traced window, in %; None untraced or
    where the trace saw no device work."""
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * t.idle_share
