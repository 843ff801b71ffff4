"""Wall-clock timers with aggregate reporting.

Capability parity with the reference's external PyTimer package (used in
AMG setup, SmoothedAggregation.py:65-66 etc., reported via Timer.report()
in examples/PCGExample_AMG.py:34).

Copied from ``pysolvers_tpu/utils/timing.py`` (importing that package
imports jax).  Host clock only: a caller timing device work synchronizes
first (``torch.cuda.synchronize``).
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict


class Timer:
    _totals: Dict[str, float] = defaultdict(float)
    _counts: Dict[str, int] = defaultdict(int)

    def __init__(self, name: str):
        self.name = name
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self):
        if self._t0 is not None:
            dt = time.perf_counter() - self._t0
            Timer._totals[self.name] += dt
            Timer._counts[self.name] += 1
            self._t0 = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    @classmethod
    def report(cls):
        if not cls._totals:
            print("Timer: nothing recorded")
            return
        width = max(len(k) for k in cls._totals)
        print(f"{'timer':<{width}}  {'total (s)':>12}  {'calls':>7}")
        for k in sorted(cls._totals):
            print(f"{k:<{width}}  {cls._totals[k]:>12.6f}  {cls._counts[k]:>7}")

    @classmethod
    def reset(cls):
        cls._totals.clear()
        cls._counts.clear()

    @classmethod
    def total(cls, name: str) -> float:
        return cls._totals.get(name, 0.0)
