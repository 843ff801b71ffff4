"""2-D grid-DIA SpMV: the stencil operator of huge structured grids.

Port of ``pysolvers_tpu/ops/grid_spmv.py``.  A flat DIA stencil on an
(mr, mc) grid re-expressed per grid offset: a flat offset decomposes as
off = dr·mc + dc with |dr|, |dc| tiny (a 9-point stencil has dr, dc in
{-1, 0, 1} at any m), and

    y[r, c] = sum_d diags[d, r, c] * x[r + dr_d, c + dc_d],

with x taken as zero off the grid in both directions.  Grid semantics
equal flat semantics iff no stored entry wraps a grid row (x[r, mc] is
x[r + 1, 0] flat but off the grid); stencil assembly never stores such
entries, and ``GridDiaMatrix.from_dia`` verifies it before converting.

* ``GridDiaMatrix`` — a frozen dataclass of tensors: the (D, mr, ldc)
  table (row pitch ldc = mc rounded up to 32 elements, so every grid row
  of every offset starts aligned), the (dr, dc) pairs on the host and as a
  device int32 (D, 2) tensor, ``dims`` = (mr, mc) and the flat ``shape``.
* ``grid_dia_spmv`` — the wrapper of kernel K6 (``csrc/grid_dia_spmv.cu``),
  the hand-written CUDA replacement of the TPU kernel ``grid_dia_spmv``
  (``_gdia_kernel``).  f32 and f64.  A CPU tensor goes to the plain twin
  ``grid_dia_spmv_torch``; a CUDA tensor launches K6 or raises — it never
  falls back.  ``k6_launch`` is that one launch; ``ops/sweep.py`` calls
  it with an epilogue, as it calls K1's.
* ``grid_dia_spmv_torch`` — the plain version: x as an (mr, mc) grid,
  zero-padded by (dr_max, dc_max), and D shifted slices times the table.

Not ported: the TPU kernel's VMEM row-tile sizing, its ``X2``/``xw``
window copy of x (K6 reads x straight from the flat vector), the
``jax.enable_x64(False)`` scope, and the 128-lane and 64-row padding of the
table (``row_block``): the port pads rows to 32 elements only.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..sparse.device import DiaMatrix, resolve_device, torch_dtype
from . import _cuda_build

# Launches of K6 since the last reset: grid_dia_spmv adds one per kernel
# launch and nowhere else.
grid_dia_spmv_launches = 0

# row pitch granule of the table, in elements (128 bytes of f32)
ROW_ALIGN = 32

_ENTRIES: dict = {}


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _decompose(offsets, mc: int, dr_max: int, dc_max: int):
    """(dr, dc) of each flat offset, dr = round(off / mc); ValueError when
    one falls outside the (dr_max, dc_max) window."""
    pairs = []
    for off in offsets:
        dr = int(np.round(off / mc))
        dc = off - dr * mc
        if abs(dr) > dr_max or abs(dc) > dc_max:
            raise ValueError(
                f"offset {off} = {dr}*mc{dc:+d} outside the grid "
                f"decomposition window (dr_max={dr_max}, dc_max={dc_max})")
        pairs.append((int(dr), int(dc)))
    return tuple(pairs)


@dataclasses.dataclass(frozen=True)
class GridDiaMatrix:
    """Stencil operator on an (mr, mc) grid, stored per grid offset.

    diags:     (D, mr, ldc), ldc >= mc — diags[d, r, c] multiplies
               x[r + dr_d, c + dc_d]; columns c >= mc are padding
    pairs:     ((dr, dc), ...) — host copy, for the plain version
    pairs_dev: (D, 2) int32 on the table's device, made once at build time
    dims:      (mr, mc); ``shape`` is the flat (n, n), n = mr·mc
    """

    diags: torch.Tensor
    pairs: tuple
    pairs_dev: torch.Tensor
    dims: tuple
    shape: tuple

    def __post_init__(self):
        D = len(self.pairs)
        mr, mc = self.dims
        if (self.diags.ndim != 3 or self.diags.shape[0] != D
                or self.diags.shape[1] != mr or self.diags.shape[2] < mc):
            raise ValueError(f"grid table {tuple(self.diags.shape)} does not "
                             f"hold {D} offsets on a {mr}x{mc} grid")
        if tuple(self.shape) != (mr * mc, mr * mc):
            raise ValueError(f"shape {self.shape} is not the flat square of "
                             f"dims {self.dims}")
        if (self.pairs_dev.dtype != torch.int32
                or tuple(self.pairs_dev.shape) != (D, 2)
                or self.pairs_dev.device != self.diags.device):
            raise ValueError("pairs_dev must be (D, 2) int32 on the table's "
                             "device")

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def ldc(self) -> int:
        return self.diags.shape[2]

    @property
    def dtype(self):
        return self.diags.dtype

    @property
    def device(self) -> torch.device:
        return self.diags.device

    @staticmethod
    def _make(G: torch.Tensor, pairs, dims) -> "GridDiaMatrix":
        mr, mc = dims
        pairs = tuple((int(a), int(b)) for a, b in pairs)
        pd = torch.tensor(pairs, dtype=torch.int32).reshape(len(pairs), 2)
        return GridDiaMatrix(G, pairs, pd.to(G.device), (int(mr), int(mc)),
                             (mr * mc, mr * mc))

    @staticmethod
    def from_numpy(G: np.ndarray, pairs, dims,
                   device=None) -> "GridDiaMatrix":
        """Upload a (D, >= mr, >= mc) grid table (e.g. the JAX package's
        padded (D, mr_pad, mc_o) one); its [:, :mr, :mc] part is kept."""
        mr, mc = dims
        G = np.asarray(G)
        T = torch.zeros((len(pairs), mr, _ceil_to(mc, ROW_ALIGN)),
                        dtype=torch_dtype(G.dtype),
                        device=resolve_device(device))
        T[:, :, :mc] = torch.from_numpy(np.array(G[:, :mr, :mc]))
        return GridDiaMatrix._make(T, pairs, dims)

    @staticmethod
    def from_dia(A: DiaMatrix, dims, dc_max: int = 8,
                 dr_max: int = 2) -> "GridDiaMatrix":
        """Convert a flat DIA stencil to grid form through the host.

        Refuses (ValueError) when an offset does not decompose into
        (|dr| <= dr_max, |dc| <= dc_max), or when a stored value sits on
        a row-wrapping position (grid semantics would drop it)."""
        mr, mc = dims
        n = A.shape[0]
        if mr * mc != n:
            raise ValueError(f"dims {dims} != n={n}")
        pairs = _decompose(A.offsets, mc, dr_max, dc_max)
        diags_h = A.diags[:, :n].cpu().numpy()
        G = np.zeros((len(pairs), mr, mc), dtype=diags_h.dtype)
        for d, (dr, dc) in enumerate(pairs):
            tbl = diags_h[d].reshape(mr, mc)
            # row-wrap check: the value at grid column c applies to x column
            # c + dc; out-of-row positions must be zero
            if dc > 0 and np.abs(tbl[:, mc - dc:]).max(initial=0) > 0:
                raise ValueError(f"offset pair {(dr, dc)} has stored "
                                 "values wrapping a grid row")
            if dc < 0 and np.abs(tbl[:, :-dc]).max(initial=0) > 0:
                raise ValueError(f"offset pair {(dr, dc)} has stored "
                                 "values wrapping a grid row")
            # rows leaving the grid (top/bottom) are zero by assembly; the
            # kernel's masks make them harmless regardless
            G[d] = tbl
        return GridDiaMatrix.from_numpy(G, pairs, dims, device=A.device)

    @staticmethod
    def from_dia_device(A: DiaMatrix, dims, dc_max: int = 8,
                        dr_max: int = 2) -> "GridDiaMatrix":
        """Conversion on the operator's device (a copy into the aligned
        grid table, no host round trip) — for operators that already live
        there, e.g. GMG levels probed at n >= 1e8.

        TRUSTS the caller that no stored value wraps a grid row (true for
        stencil assembly and Galerkin-probed coarse operators; ``from_dia``
        verifies it)."""
        mr, mc = dims
        n = A.shape[0]
        if mr * mc != n:
            raise ValueError(f"dims {dims} != n={n}")
        pairs = _decompose(A.offsets, mc, dr_max, dc_max)
        G = A.diags.new_zeros((len(pairs), mr, _ceil_to(mc, ROW_ALIGN)))
        G[:, :, :mc] = A.diags[:, :n].reshape(len(pairs), mr, mc)
        return GridDiaMatrix._make(G, pairs, dims)


def grid_dia_spmv_torch(A: GridDiaMatrix, x: torch.Tensor) -> torch.Tensor:
    """K6's twin: pad the (mr, mc) grid of x with zeros by (dr_max,
    dc_max) and sum the D shifted slices times the table, in pair order."""
    mr, mc = A.dims
    acc = torch.zeros((mr, mc), dtype=A.dtype, device=A.device)
    if not A.pairs:
        return acc.reshape(-1)
    drm = max(abs(dr) for dr, _ in A.pairs)
    dcm = max(abs(dc) for _, dc in A.pairs)
    xp = torch.nn.functional.pad(x.to(A.dtype).reshape(mr, mc),
                                 (dcm, dcm, drm, drm))
    for d, (dr, dc) in enumerate(A.pairs):
        acc = acc + A.diags[d, :, :mc] * xp[drm + dr: drm + dr + mr,
                                            dcm + dc: dcm + dc + mc]
    return acc.reshape(-1)


def _k6_entry(dtype):
    fn = _ENTRIES.get(dtype)
    if fn is None:
        lib = _cuda_build.load("grid_dia_spmv")
        fn = (lib.grid_dia_spmv_f32 if dtype == torch.float32
              else lib.grid_dia_spmv_f64)
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 5
                       + [ctypes.c_double, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _ENTRIES[dtype] = fn
    return fn


def k6_launch(A: GridDiaMatrix, x: torch.Tensor, f=None, dinv=None,
              omega: float = 0.0,
              epilogue: int = _cuda_build.PRODUCT) -> torch.Tensor:
    """One launch of K6 on CUDA tensors the caller has checked: A @ x
    with ``epilogue`` (``_cuda_build.PRODUCT``, ``RESIDUAL`` f − A x, or
    ``JACOBI`` x + (omega·dinv)·(f − A x)).  Counted as every K6 launch
    is."""
    global grid_dia_spmv_launches
    if A.diags.stride(2) != 1:
        raise ValueError("K6 takes a table with contiguous rows")
    y = torch.empty(A.n_rows, dtype=A.dtype, device=x.device)
    if A.n_rows == 0:
        return y
    mr, mc = A.dims
    fn = _k6_entry(A.dtype)
    with torch.cuda.device(x.device):
        rc = fn(A.diags.data_ptr(), A.pairs_dev.data_ptr(), x.data_ptr(),
                _cuda_build.data_ptr(f), _cuda_build.data_ptr(dinv),
                y.data_ptr(), mr, mc, A.diags.stride(0), A.diags.stride(1),
                len(A.pairs), omega, epilogue,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K6 (grid_dia_spmv) launch failed: CUDA error "
                           f"{rc}")
    grid_dia_spmv_launches += 1
    _cuda_build.count_launch("K6", A.dtype)
    return y


def grid_dia_spmv(A: GridDiaMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for flat x of length n = mr·mc: kernel K6 on CUDA, its
    twin on the CPU."""
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"grid SpMV takes float32 or float64, got {A.dtype}")
    if x.dtype != A.dtype:
        raise TypeError(f"x is {x.dtype}, the operator {A.dtype}")
    if tuple(x.shape) != (A.n_cols,):
        raise ValueError(f"x has shape {tuple(x.shape)}, the operator "
                         f"{A.shape}")
    if x.device != A.device:
        raise ValueError(f"x is on {x.device}, the operator on {A.device}")
    if x.device.type == "cpu":
        return grid_dia_spmv_torch(A, x)
    if x.device.type != "cuda":
        raise ValueError(f"grid SpMV runs on CPU or CUDA, not {x.device}")
    if not x.is_contiguous():
        raise ValueError("K6 takes a contiguous x")
    return k6_launch(A, x)
