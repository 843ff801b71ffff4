"""Wall-clock timers and counters with aggregate reporting, on the
profiler's clock while it runs.

Capability parity with the reference's external PyTimer package (used in
AMG setup, SmoothedAggregation.py:65-66 etc., reported via Timer.report()
in examples/PCGExample_AMG.py:34).

Copied from ``pysolvers_tpu/utils/timing.py`` (importing that package
imports jax), with two kinds of span and a counter:

* ``Timer(name)`` is always on: its total and call count are kept on the
  host clock (``time.perf_counter``), whether the profiler runs or not.
  The setup stages ("amg.*", "gmg.*", "bdia.*") use it; each runs a few
  times per setup.
* ``traced(name)`` is a ``Timer`` only while a ``torch.profiler`` session
  runs (``tracing()``), and otherwise a shared no-op: a site inside the
  solve loop ("krylov.*", "amg.apply", "amg.level.<k>", "bmg.*") costs
  one check with tracing off and records nothing.
* ``Timer.count(name)`` adds to a counter that has no total
  ("host_reads", ``core.host_read``).

While the profiler runs, every span also opens a profiler annotation of
its name (``annotation``, a RecordFunction).  Kineto stamps those on the
clock of the device's kernel and copy records, so the card's idle
stretches in a trace fall under the program's spans.  A span adds no
launch, sync or read of its own; a caller timing device work on the host
clock synchronizes first (``torch.cuda.synchronize``).
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import nullcontext
from typing import Dict

import torch
from torch.autograd import _profiler_enabled as tracing
from torch.autograd.profiler import record_function

# torch's lighter binding of a RecordFunction where it has one (the one
# torch.compile's regions use): with the profiler on, a span around a
# launch costs 2-5 µs of an H100 host's time against 10-23 µs through
# ``record_function``
annotation = getattr(torch._C._profiler, "_RecordFunctionFast",
                     record_function)

# what ``traced`` hands back with the profiler off
_OFF = nullcontext()


class Timer:
    _totals: Dict[str, float] = defaultdict(float)
    _counts: Dict[str, int] = defaultdict(int)

    def __init__(self, name: str):
        self.name = name
        self._t0 = None
        self._annotation = None

    def start(self):
        if tracing():
            self._annotation = annotation(self.name)
            self._annotation.__enter__()
        self._t0 = time.perf_counter()
        return self

    def stop(self):
        if self._t0 is not None:
            dt = time.perf_counter() - self._t0
            Timer._totals[self.name] += dt
            Timer._counts[self.name] += 1
            self._t0 = None
        if self._annotation is not None:
            self._annotation.__exit__(None, None, None)
            self._annotation = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    @classmethod
    def count(cls, name: str, n: int = 1):
        """Add ``n`` to the counter ``name`` (a count with no total)."""
        cls._counts[name] += n

    @classmethod
    def report(cls):
        names = sorted(set(cls._totals) | set(cls._counts))
        if not names:
            print("Timer: nothing recorded")
            return
        width = max(len(k) for k in names)
        print(f"{'timer':<{width}}  {'total (s)':>12}  {'calls':>7}")
        for k in names:
            total = (f"{cls._totals[k]:>12.6f}" if k in cls._totals
                     else f"{'-':>12}")
            print(f"{k:<{width}}  {total}  {cls._counts.get(k, 0):>7}")

    @classmethod
    def reset(cls):
        cls._totals.clear()
        cls._counts.clear()

    @classmethod
    def total(cls, name: str) -> float:
        return cls._totals.get(name, 0.0)

    @classmethod
    def calls(cls, name: str) -> int:
        """The spans ``name`` closed, or the counter ``name``."""
        return cls._counts.get(name, 0)


def traced(name: str):
    """A span of ``name`` that is recorded only while the profiler runs
    (a ``Timer``); otherwise the shared no-op context."""
    return Timer(name) if tracing() else _OFF
