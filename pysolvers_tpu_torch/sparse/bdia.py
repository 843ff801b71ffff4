"""Block-DIA: block-banded matrices as dense b×b blocks on block-diagonals.

Port of ``pysolvers_tpu/sparse/bdia.py``.  An RCM-ordered multi-dof
discretisation is block-banded, so its dense b×b blocks are stored along
block-diagonals and the SpMV is gather-free shift-and-FMA, like DIA with
the block mixing fused in (kernels K4/K5, ``ops/spmv.py``).

Layout — PLANAR (dof-major) vector ordering: solve-side vectors hold all
dof-0 values first, then dof-1, ... (x_planar[p·nb + i] = x[i·b + p]).
Each (q, p) plane of a block-diagonal is then a contiguous nb-long stream
FMA'd against a shifted nb-segment of x.  Blocks are stored as
``planes[d·b + q, p, i] = A[i·b + p, (i + offsets[d])·b + q]``, the JAX
package's layout, so packs carry across unchanged (``convert.py``).
``to_planar``/``from_planar`` reorder once per solve, not per product.

The numpy pack is the JAX package's line for line, so both give the same
planes bit for bit, including the ``row_tile`` rule for the padded length
``nb_pad`` (the kernels read only ``i < nb``; the rule is kept so that the
packs match).  Planes and a device int32 copy of the offsets live on the
matrix's ``device`` (None: the current CUDA device; it raises where there
is none).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import _round_up, numpy_dtype, resolve_device, torch_dtype
from .host import HostCSR

# structure-keyed layout plans (block offsets + per-nnz scatter targets),
# bounded as in the JAX package
_BDIA_PLAN_CACHE: dict = {}


@dataclasses.dataclass(frozen=True)
class BdiaMatrix:
    """Block-banded matrix as dense blocks on block-diagonals.

    planes:      (n_boffs·b, b, nb_pad) — planes[d·b+q, p, i] =
                 A[i·b+p, (i+offsets[d])·b+q]
    offsets:     tuple of BLOCK offsets (host copy, for the twins)
    offsets_dev: (n_boffs,) int32 on the planes' device, for the kernels
    shape:       the SCALAR shape (n, n);  b: the block size

    ``matvec``/``matmat`` operate on PLANAR-ordered vectors.
    """

    planes: torch.Tensor
    offsets: tuple
    offsets_dev: torch.Tensor
    shape: tuple
    b: int

    def __post_init__(self):
        D = len(self.offsets)
        n, m = self.shape
        if n != m or n % self.b:
            raise ValueError(f"shape {self.shape} is not square in whole "
                             f"blocks of {self.b}")
        if (self.planes.ndim != 3
                or tuple(self.planes.shape[:2]) != (D * self.b, self.b)
                or self.planes.shape[2] < n // self.b):
            raise ValueError(f"planes {tuple(self.planes.shape)} do not hold "
                             f"{D} block offsets of {self.b}×{self.b} blocks "
                             f"for {n // self.b} block rows")
        if (self.offsets_dev.dtype != torch.int32
                or tuple(self.offsets_dev.shape) != (D,)
                or self.offsets_dev.device != self.planes.device):
            raise ValueError("offsets_dev must be (D,) int32 on the planes' "
                             "device")

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def nb(self) -> int:
        return self.shape[0] // self.b

    @property
    def nb_pad(self) -> int:
        return self.planes.shape[-1]

    @property
    def dtype(self):
        return self.planes.dtype

    @property
    def device(self) -> torch.device:
        return self.planes.device

    @property
    def nnz_stored(self) -> int:
        return self.planes.numel()

    @staticmethod
    def from_numpy(planes: np.ndarray, offsets, shape, b: int, dtype=None,
                   device=None) -> "BdiaMatrix":
        """Upload a (D·b, b, nb_pad) plane table and its D block offsets."""
        device = resolve_device(device)
        offsets = tuple(int(o) for o in offsets)
        return BdiaMatrix(
            torch.as_tensor(planes, dtype=torch_dtype(dtype), device=device),
            offsets, torch.tensor(offsets, dtype=torch.int32, device=device),
            tuple(int(s) for s in shape), int(b))

    @staticmethod
    def from_host_csr(A: HostCSR, b: int, dtype=None, row_tile: int = None,
                      device=None) -> "BdiaMatrix":
        """Pack a host CSR (node-major, n divisible by ``b``) into planar
        block-DIA.  Blocks are dense in storage (absent entries are
        zeros).  The layout plan is cached on the sparsity structure."""
        n, m = A.shape
        if n != m:
            raise ValueError("BdiaMatrix is square-only")
        if n % b != 0:
            raise ValueError(f"n={n} not divisible by block size b={b}")
        nb = n // b
        dtype = numpy_dtype(dtype) or A.data.dtype
        if row_tile is None:
            # the JAX package's tile grid (its kernel's alignment)
            row_tile = 16384 if nb > 16384 else 128
        nb_pad = _round_up(max(nb, 1), row_tile)

        # nb_pad is baked into the flat scatter targets, so it keys the plan
        key = (hash(A.indptr.tobytes()), hash(A.indices.tobytes()),
               A.nnz, A.shape, b, nb_pad)
        ent = _BDIA_PLAN_CACHE.get(key)
        if ent is None:
            rows, cols, _ = A.to_coo()
            br, p = rows // b, rows % b
            bc, q = cols // b, cols % b
            boffs = np.unique(bc - br)
            d_idx = np.searchsorted(boffs, bc - br)
            # flat scatter target into (n_boffs·b [d,q], b [p], nb_pad)
            flat = ((d_idx * b + q) * b + p) * nb_pad + br
            ent = (tuple(int(o) for o in boffs), flat.astype(np.int64))
            if len(_BDIA_PLAN_CACHE) > 16:
                _BDIA_PLAN_CACHE.pop(next(iter(_BDIA_PLAN_CACHE)))
            _BDIA_PLAN_CACHE[key] = ent
        boffs, flat = ent
        planes = np.zeros(len(boffs) * b * b * nb_pad, dtype=dtype)
        planes[flat] = A.data
        planes = planes.reshape(len(boffs) * b, b, nb_pad)
        return BdiaMatrix.from_numpy(planes, boffs, (n, n), b, device=device)

    # ---------------- planar-order boundary helpers ----------------

    def to_planar(self, x: torch.Tensor) -> torch.Tensor:
        """Node-major (n,) or (n, k) -> planar ordering (one transpose,
        paid at solve entry, not per product)."""
        nb, b = self.nb, self.b
        if x.ndim == 1:
            return x.reshape(nb, b).T.reshape(nb * b)
        k = x.shape[1]
        return x.reshape(nb, b, k).permute(1, 0, 2).reshape(nb * b, k)

    def from_planar(self, x: torch.Tensor) -> torch.Tensor:
        nb, b = self.nb, self.b
        if x.ndim == 1:
            return x.reshape(b, nb).T.reshape(nb * b)
        k = x.shape[1]
        return x.reshape(b, nb, k).permute(1, 0, 2).reshape(nb * b, k)

    @staticmethod
    def is_profitable(A: HostCSR, b: int, max_boffs: int = 32) -> bool:
        """Block-banded enough: few distinct block offsets AND the dense
        block storage doesn't balloon past ~2.5× the scalar nnz."""
        n = A.shape[0]
        if n % b != 0 or A.shape[0] != A.shape[1]:
            return False
        rows, cols, _ = A.to_coo()
        boffs = np.unique(cols // b - rows // b)
        if len(boffs) > max_boffs:
            return False
        stored = len(boffs) * b * b * (n // b)
        return stored <= 2.5 * A.nnz

    def _d0(self) -> int:
        if 0 not in self.offsets:
            raise ValueError("BdiaMatrix has no offset-0 block diagonal")
        return self.offsets.index(0)

    def diag_blocks(self) -> torch.Tensor:
        """(nb, b, b) diagonal blocks D_i as [i, p, q] (a view of the
        planes) — the block-Jacobi setup input."""
        d0 = self._d0()
        return self.planes[d0 * self.b:(d0 + 1) * self.b, :,
                           :self.nb].permute(2, 1, 0)

    def diagonal_planar(self) -> torch.Tensor:
        """Scalar diagonal in PLANAR ordering, shape (b·nb,)."""
        d0 = self._d0()
        idx = torch.arange(self.b, device=self.device)
        return self.planes[d0 * self.b + idx, idx, :self.nb].reshape(
            self.b * self.nb)

    def host_matvec_planar(self, x) -> np.ndarray:
        """f64 numpy product on PLANAR-ordered x (a host oracle)."""
        pl_ = self.planes.detach().cpu().numpy().astype(np.float64)
        b, nb = self.b, self.nb
        xb = np.asarray(x, dtype=np.float64).reshape(b, nb)
        acc = np.zeros((b, nb))
        for d, off in enumerate(self.offsets):
            lo = max(0, -off)
            hi = min(nb, nb - off)
            if hi <= lo:
                continue
            for q in range(b):
                acc[:, lo:hi] += (pl_[d * b + q][:, lo:hi]
                                  * xb[q, lo + off:hi + off])
        return acc.reshape(b * nb)

    def to_host_csr(self) -> HostCSR:
        pl_ = self.planes.detach().cpu().numpy()
        nb, b = self.nb, self.b
        rows_l, cols_l, vals_l = [], [], []
        for d, off in enumerate(self.offsets):
            for q in range(b):
                for p in range(b):
                    i = np.arange(nb)
                    j = i + off
                    ok = (j >= 0) & (j < nb)
                    rows_l.append(i[ok] * b + p)
                    cols_l.append(j[ok] * b + q)
                    vals_l.append(pl_[d * b + q, p, i[ok]])
        return HostCSR.from_coo(np.concatenate(rows_l),
                                np.concatenate(cols_l),
                                np.concatenate(vals_l), self.shape)

    def astype(self, dtype) -> "BdiaMatrix":
        return dataclasses.replace(self,
                                   planes=self.planes.to(torch_dtype(dtype)))


def detect_block_size(A: HostCSR, candidates=(8, 7, 6, 5, 4, 3, 2),
                      max_boffs: int = 32, min_density: float = 0.7):
    """Largest candidate b for which ``A`` has genuine b×b block-DIA
    structure, or None.

    Two tests per candidate: few distinct BLOCK offsets (block-banded),
    and block DENSITY ≥ ``min_density`` — the fraction of dense-block
    storage positions that hold a structural nonzero.  A scalar 5-point
    stencil at b=2 has density 0.5 and is rejected (``solve()`` keeps the
    scalar AMG route for it); a multi-dof discretisation with dense
    blocks sits near 1.0.  Cost: one COO view + one unique per candidate,
    O(nnz·|candidates|) on the host.  Feeds ``solve()``'s reroute of
    block-structured HostCSR systems to the block-DIA lane.
    """
    n, m = A.shape
    if n != m or A.nnz == 0:
        return None
    rows, cols, _ = A.to_coo()
    for b in candidates:
        if n % b:
            continue
        boffs = np.unique(cols // b - rows // b)
        if len(boffs) > max_boffs:
            continue
        if A.nnz >= min_density * len(boffs) * b * b * (n // b):
            return b
    return None
