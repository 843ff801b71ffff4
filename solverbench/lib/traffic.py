"""The one generator of every mix: ``traffic/<mix>.json`` gives its
parameters, ``--seed`` its draws, and the file of its ``variation``,
``variations/<variation>.py``, how the operator changes from one solve to
the next.

All mixes are a closed loop with one caller, each solve from x0 = 0.  Draw
k gives x*_k, uniform on [0, 1) per unknown, of shape (n,) or, where the
mix sets ``columns``, (n, columns), then the operator's draw
(``Variation.next``), and b_k = A_k x*_k, made on the device with torch's
own sparse product from the benchmark's CSR (``Variation.matvec``), not by
the program.  The draws come from one ``torch.Generator`` on the device seeded
with the seed, in a fixed order, so that one seed gives one sequence of
inputs and every seed the same sizes.
"""
from __future__ import annotations

import warnings

from . import spec as S


class Traffic:
    def __init__(self, mix: dict, A, seed: int, device: str):
        import torch
        self.mix = mix
        self.A = A
        self.device = device
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed) % (1 << 63))
        with warnings.catch_warnings():
            # torch calls its sparse CSR support beta
            warnings.simplefilter("ignore", UserWarning)
            A_dev = torch.sparse_csr_tensor(
                torch.as_tensor(A.indptr, dtype=torch.int64),
                torch.as_tensor(A.indices, dtype=torch.int64),
                torch.as_tensor(A.data, dtype=torch.float64),
                size=(A.n, A.n), check_invariants=True).to(device)
        self.variation = S.plugin("variations", mix["variation"]).Variation(
            mix, A, A_dev, self.uniform)
        self.frozen = self.variation.frozen
        self.shape = ((A.n,) if mix.get("columns") is None
                      else (A.n, mix["columns"]))

    def uniform(self, lo=0.0, hi=1.0, shape=None):
        """Uniform draws on [lo, hi) on the device, float64, of ``shape``
        (default (n,))."""
        import torch
        u = torch.rand(shape or (self.A.n,), generator=self.gen,
                       device=self.device, dtype=torch.float64)
        return lo + (hi - lo) * u

    def draw(self):
        """(x*, state, b) of the next solve on the device; ``state`` is
        the variation's draw (None for a frozen operator)."""
        x_star = self.uniform(shape=self.shape)
        state = self.variation.next()
        return x_star, state, self.variation.matvec(state, x_star)

    def host(self, state):
        """The benchmark's CSR of the operator of the solve drawn as
        ``state``."""
        return self.variation.host(state)
