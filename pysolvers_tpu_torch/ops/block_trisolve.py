"""Exact block-banded triangular solves: the ILU(t)/IC(t) applies of
``trisolve_mode="block"``, which "auto" takes on a CUDA device.

Port of ``pysolvers_tpu/ops/block_trisolve.py``.  After RCM ordering an
incomplete factor is banded.  Cut into contiguous row blocks of ``bs``, it is
block-banded with ``p`` subdiagonal blocks (its block reach), and

    x_i = L_ii^{-1} (b_i - sum_{j=1..p} S_{i,j} x_{i-j})

is a linear recurrence over the blocks with dense bs x bs operators.  The
plan holds the dense inverses of the diagonal blocks (``dinv``, computed by
nilpotent doubling with ``torch.bmm``, as the JAX package computes them with
an einsum outside any kernel) and ``s_hat_i = dinv_i [S_{i,p} ... S_{i,1}]``.
An upper factor is solved by reversal: with J the index reversal, J U J is
lower triangular.

* ``block_trisolve`` — the wrapper of kernel K8 (``csrc/block_trisolve.cu``),
  the hand-written CUDA form of the JAX package's ``lax.scan``
  (``block_trisolve.py:349-381``; XLA ops there, not a Pallas kernel): one
  launch per solve, f32 and f64: the diagonal blocks over all SMs, then
  the walk over the blocks on one thread-block cluster, whose size
  ``k8_launch_geometry`` picks (the kernel's source works out the rest of
  the geometry; ``k8_geometry`` reports it).  A CPU tensor goes to the
  plain twin ``block_trisolve_torch``; a CUDA tensor launches K8 or
  raises.
* ``block_trisolve_torch`` — the twin: a batched product for the diagonal
  blocks, then a Python loop over the blocks, as ``lax.scan`` runs them.
* ``build_block_trisolve_plan`` / ``build_block_trisolve_plan_pair`` — the
  plans, checked on the host (triangularity entry by entry, block reach
  against ``max_p``, dense bytes against ``max_bytes``, the int32 range of
  the scatter indices) before anything is uploaded; the dense build and
  the inversion run on the plan's device.

Not ported: ``build_ic_block_trisolve_plan_pair`` and the ``flip_pad``
reversal it needs (they derive the Lᵀ plan on the device to save a TPU
upload, and no preconditioner calls them, ``linear/ilu.py:505-513``), and
the ``defer``/``SetupItem``/``fused_build`` one-dispatch setup
(``ops/fuse.py`` is on the do-not-port list).
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import math

import numpy as np
import torch

from ..sparse.device import resolve_device, torch_dtype
from ..sparse.host import HostCSR
from . import _cuda_build

# Launches of K8 since the last reset: the wrapper adds one per solve it
# launches (stage 1 and, for p > 0, stage 2 of the C entry) and nowhere else.
block_trisolve_launches = 0

# K8 holds a block of b (stage 1) and p + 1 blocks of x (stage 2) in
# shared memory; the ring of x blocks stays within 48 KB
K8_MAX_BS = 1024
K8_SHARED_BYTES = 48 * 1024

# K8's stage 2 (csrc/block_trisolve.cu) runs on one thread-block cluster:
# the sizes tried in order (16 CTAs where the card fits it, else 8)
K8_CLUSTERS = (16, 8)


@dataclasses.dataclass(frozen=True)
class K8Geometry:
    """The launch geometry of K8's stage 2 for one (bs, p, dtype, cluster),
    as the kernel's source works it out (``block_trisolve_geometry``).

    cluster:        CTAs in the cluster
    rows:           rows of each step a CTA owns (CTA c: c*rows onwards;
                    the last CTAs may own fewer, or none)
    rows_per_chunk: whole rows of ``s_hat`` in one stage of the stream
    chunks:         chunks of a full CTA's slice per step
    stages:         stages of the stream in shared memory
    chunk_bytes:    one stage's bytes (a multiple of 128)
    smem_bytes:     the CTA's dynamic shared memory: the mbarriers (one
                    per stage, two for x), the ring of p + 1 x blocks, the
                    stages
    bulk:           rows of s_hat are 16-byte multiples: each chunk is one
                    bulk async copy (TMA); else cp.async of one value each
    vec:            rows of x a compute warp computes together and sends
                    to each CTA as one 16-byte message (16 / itemsize,
                    where rows, bs and rows_per_chunk are its multiples;
                    else 1)
    """

    cluster: int
    rows: int
    rows_per_chunk: int
    chunks: int
    stages: int
    chunk_bytes: int
    smem_bytes: int
    bulk: bool
    vec: int


def k8_geometry(bs: int, p: int, itemsize: int, cluster: int) -> K8Geometry:
    """K8's stage-2 geometry for blocks of ``bs`` rows, block reach ``p``
    >= 1 and values of ``itemsize`` bytes on a cluster of ``cluster`` CTAs,
    asked of the kernel's library (so it builds K8).  Raises ValueError
    where none fits."""
    out = (ctypes.c_int * 8)()
    if _k8_lib().block_trisolve_geometry(bs, p, itemsize, cluster, out):
        raise ValueError(f"no K8 stage 2 for bs = {bs}, p = {p}, "
                         f"{itemsize}-byte values, cluster = {cluster}")
    rows, per_chunk, chunks, stages, chunk_bytes, smem, bulk, vec = out
    return K8Geometry(cluster, rows, per_chunk, chunks, stages, chunk_bytes,
                      smem, bool(bulk), vec)


# (dtype, bs, p, device) -> the K8Geometry the card runs
_K8_GEOMETRY: dict = {}

_K8_ENTRIES: dict = {}


@dataclasses.dataclass(frozen=True)
class BlockTriSolvePlan:
    """Device-resident plan of one triangular factor.

    s_hat: (nb, bs, p*bs)  dinv_i @ [S_{i,p} ... S_{i,1}] (oldest block
           first: column block j multiplies x_{i-p+j})
    dinv:  (nb, bs, bs)    dense inverses of the diagonal blocks
    flip:  an upper factor, solved reversed
    """

    s_hat: torch.Tensor
    dinv: torch.Tensor
    n: int
    bs: int
    p: int
    flip: bool

    @property
    def nb(self) -> int:
        return self.dinv.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.dinv.dtype

    @property
    def device(self) -> torch.device:
        return self.dinv.device


@contextlib.contextmanager
def _full_precision_matmul():
    """f32 products at full precision (JAX: ``Precision.HIGHEST``): a TF32
    inverse would make the exact plan inexact at ~1e-3."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _tri_inverse_doubling(D: torch.Tensor) -> torch.Tensor:
    """Batched inverse of dense lower-triangular blocks (nb, bs, bs) by
    nilpotent doubling: D = (I + K) diag(d), K strictly lower, so
    (I + K)^{-1} = prod_k (I + (-K)^(2^k)), exact in exact arithmetic."""
    nb, bs, _ = D.shape
    d = torch.diagonal(D, dim1=1, dim2=2)                     # (nb, bs)
    dinv = 1.0 / d
    # column-normalize: K[i, j] = S[i, j] / d_j
    tri = torch.tril(torch.ones(bs, bs, dtype=D.dtype, device=D.device), -1)
    X = -(D * tri * dinv[:, None, :])                         # (-K)^1
    inv = torch.eye(bs, dtype=D.dtype, device=D.device) + X
    with _full_precision_matmul():
        for _ in range(max(int(math.ceil(math.log2(bs))) - 1, 0)):
            X = torch.bmm(X, X)                               # (-K)^(2^k)
            inv = inv + torch.bmm(inv, X)
    return dinv[:, :, None] * inv                             # diag(d)^{-1} ·


def _prep(rows, cols, vals, n, nb, bs, p):
    """Host-side scatter indices into the wide (nb, bs, (p+1)·bs) array,
    shipped as int32: refuse a wide array too large for int32 instead of
    letting the cast wrap silently."""
    blk_r = rows // bs
    reach = blk_r - cols // bs
    wide = (p + 1) * bs
    if nb * bs * wide >= 2 ** 31:
        raise ValueError(
            f"block plan wide array ({nb * bs * wide} elements) exceeds "
            "int32 scatter-index range; reduce max_bytes/problem size or "
            "use another trisolve mode")
    flat_idx = (blk_r * bs + rows % bs) * wide + (p - reach) * bs \
        + cols % bs
    return vals, flat_idx.astype(np.int32)


def _host_plan(T: HostCSR, lower: bool, bs: int, dtype, max_p: int,
               max_bytes: int):
    """The host half of a plan: (values, int32 scatter indices, n, nb, p,
    flip), every refusal raised here, before anything is uploaded."""
    n = T.shape[0]
    rows, cols, vals = T.to_coo()
    vals = vals.astype(dtype)
    if not lower:
        rows, cols = (n - 1) - rows, (n - 1) - cols
    # element-wise, not block-level: an above-diagonal entry INSIDE a
    # diagonal block passes a block-reach check but would be silently
    # masked by the tril mask of the doubling inverse — a wrong solve
    if (cols > rows).any():
        raise ValueError("matrix is not (reversed-)lower triangular")
    nb = max((n + bs - 1) // bs, 1)
    p = int((rows // bs - cols // bs).max(initial=0))
    if p > max_p:
        raise ValueError(f"block reach {p} exceeds max_p={max_p}; factor "
                         "not banded enough for the block path")
    if nb * bs * bs * (2 * p + 2) * np.dtype(dtype).itemsize > max_bytes:
        raise ValueError("dense block storage would exceed max_bytes")
    vals, flat_idx = _prep(rows, cols, vals, n, nb, bs, p)
    return vals, flat_idx, n, nb, p, not lower


def _plans_from_wide(W: torch.Tensor, bs: int, p: int, unit_diag: bool):
    """(s_hat, dinv) from the wide array [S_p | ... | S_1 | D] per block
    row.  A unit-diagonal factor gets 1 on D's diagonal; otherwise the pad
    rows (and any structurally missing diagonal) do."""
    nb = W.shape[0]
    D = W[:, :, p * bs:]
    eye = torch.eye(bs, dtype=W.dtype, device=W.device)
    if unit_diag:
        D = D * (1.0 - eye) + eye
    else:
        d = torch.diagonal(D, dim1=1, dim2=2)
        d_ok = torch.where(d == 0, torch.ones_like(d), d)
        D = torch.where(eye.bool()[None], d_ok[:, :, None] * eye[None], D)
    dinv = _tri_inverse_doubling(D)
    if p:
        with _full_precision_matmul():
            s_hat = torch.bmm(dinv, W[:, :, : p * bs])
    else:
        s_hat = W.new_zeros((nb, bs, 0))
    return s_hat, dinv


def _device_plan(host, bs: int, unit_diag: bool, device) -> BlockTriSolvePlan:
    vals, flat_idx, n, nb, p, flip = host
    dt = torch_dtype(vals.dtype)
    W = torch.zeros(nb * bs * (p + 1) * bs, dtype=dt, device=device)
    W[torch.as_tensor(flat_idx, device=device).long()] = torch.as_tensor(
        vals, device=device)
    s_hat, dinv = _plans_from_wide(W.view(nb, bs, (p + 1) * bs), bs, p,
                                   unit_diag)
    return BlockTriSolvePlan(s_hat.contiguous(), dinv.contiguous(), n, bs, p,
                             flip)


def build_block_trisolve_plan(T: HostCSR, lower: bool, unit_diag: bool = False,
                              bs: int = 256, dtype=np.float32,
                              max_p: int = 4, max_bytes: int = 2 << 30,
                              device=None) -> BlockTriSolvePlan:
    """Pack a banded triangular HostCSR into a block-banded plan on
    ``device``.  Raises ValueError when the factor is not triangular, its
    block reach exceeds ``max_p`` (not banded enough: the caller falls back
    to another trisolve mode) or its dense blocks exceed ``max_bytes``."""
    host = _host_plan(T, lower, bs, dtype, max_p, max_bytes)
    return _device_plan(host, bs, unit_diag, resolve_device(device))


def build_block_trisolve_plan_pair(T_lo: HostCSR, T_up: HostCSR,
                                   unit_lo: bool = False,
                                   unit_up: bool = False,
                                   bs: int = 256, dtype=np.float32,
                                   max_p: int = 4, max_bytes: int = 2 << 30,
                                   device=None):
    """The (lower, upper) plans of a factorization: both factors are
    checked on the host before either is built, so a refusal uploads
    nothing."""
    hosts = [_host_plan(T, lower, bs, dtype, max_p, max_bytes)
             for T, lower in ((T_lo, True), (T_up, False))]
    device = resolve_device(device)
    return tuple(_device_plan(h, bs, unit, device)
                 for h, unit in zip(hosts, (unit_lo, unit_up)))


def block_trisolve_torch(plan: BlockTriSolvePlan, b: torch.Tensor
                         ) -> torch.Tensor:
    """Solve T x = b with the plan in plain torch (K8's twin): b reversed
    for an upper factor and padded to nb·bs in the plan's dtype, the
    diagonal blocks' products in one batch, then block by block
    x_i = u_i - s_hat_i [x_{i-p} ... x_{i-1}] (zeros before block 0)."""
    n, bs, p, nb, dt = plan.n, plan.bs, plan.p, plan.nb, plan.dtype
    bp = torch.zeros(nb * bs, dtype=dt, device=b.device)
    bp[:n] = (b.flip(0) if plan.flip else b).to(dt)
    with _full_precision_matmul():
        xs = torch.bmm(plan.dinv, bp.view(nb, bs, 1)).view(nb * bs)
        if p:
            u = xs
            # p leading zero blocks: the carry of block i is one slice
            xs = torch.zeros((nb + p) * bs, dtype=dt, device=b.device)
            for i in range(nb):
                xs[(i + p) * bs:(i + p + 1) * bs] = (
                    u[i * bs:(i + 1) * bs]
                    - plan.s_hat[i] @ xs[i * bs:(i + p) * bs])
            xs = xs[p * bs:]
    x = xs[:n]
    return (x.flip(0) if plan.flip else x).to(b.dtype)


def _k8_lib():
    lib = _cuda_build.load("block_trisolve")
    lib.block_trisolve_error_string.argtypes = [ctypes.c_int]
    lib.block_trisolve_error_string.restype = ctypes.c_char_p
    lib.block_trisolve_geometry.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.block_trisolve_geometry.restype = ctypes.c_int
    for query in (lib.block_trisolve_max_clusters_f32,
                  lib.block_trisolve_max_clusters_f64):
        query.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        query.restype = ctypes.c_int
    return lib


def _k8_error(rc: int) -> str:
    name = _k8_lib().block_trisolve_error_string(rc)
    return f"CUDA error {rc} ({name.decode()})"


def _k8_entry(dtype):
    fn = _K8_ENTRIES.get(dtype)
    if fn is None:
        lib = _k8_lib()
        fn = (lib.block_trisolve_f32 if dtype == torch.float32
              else lib.block_trisolve_f64)
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _K8_ENTRIES[dtype] = fn
    return fn


def k8_launch_geometry(plan: BlockTriSolvePlan) -> K8Geometry | None:
    """The stage-2 geometry K8 launches for ``plan`` on its card (None for
    p = 0, where stage 1 is the whole solve): a cluster of 16 CTAs where
    ``cudaOccupancyMaxActiveClusters`` says the card runs one, else of 8.
    Asked once per (dtype, bs, p, device); raises when neither fits."""
    if plan.p == 0:
        return None
    key = (plan.dtype, plan.bs, plan.p, plan.device)
    geo = _K8_GEOMETRY.get(key)
    if geo is not None:
        return geo
    lib = _k8_lib()
    query = (lib.block_trisolve_max_clusters_f32
             if plan.dtype == torch.float32
             else lib.block_trisolve_max_clusters_f64)
    for cluster in K8_CLUSTERS:
        geo = k8_geometry(plan.bs, plan.p, plan.dinv.element_size(), cluster)
        fits = ctypes.c_int(0)
        with torch.cuda.device(plan.device):
            rc = query(plan.bs, plan.p, cluster, ctypes.byref(fits))
        if rc != 0:
            raise RuntimeError(f"K8: the occupancy query of a {cluster}-CTA "
                               f"cluster with {geo.smem_bytes} bytes of "
                               f"shared memory failed: {_k8_error(rc)}")
        if fits.value >= 1:
            _K8_GEOMETRY[key] = geo
            return geo
    raise RuntimeError(f"K8: the card runs no cluster of "
                       f"{' or '.join(map(str, K8_CLUSTERS))} CTAs with "
                       f"{geo.smem_bytes} bytes of shared memory each "
                       f"(bs = {plan.bs}, p = {plan.p}, {plan.dtype})")


def block_trisolve(plan: BlockTriSolvePlan, b: torch.Tensor) -> torch.Tensor:
    """Solve T x = b exactly with the plan: kernel K8 on CUDA, its twin on
    the CPU.  Computes in the plan's dtype and returns b's."""
    global block_trisolve_launches
    n, bs, p, nb, dt = plan.n, plan.bs, plan.p, plan.nb, plan.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"the block trisolve takes float32 or float64 "
                        f"plans, got {dt}")
    if tuple(b.shape) != (n,):
        raise ValueError(f"b has shape {tuple(b.shape)}, the plan n = {n}")
    if b.device != plan.device:
        raise ValueError(f"b is on {b.device}, the plan on {plan.device}")
    if b.device.type == "cpu":
        return block_trisolve_torch(plan, b)
    if b.device.type != "cuda":
        raise ValueError(f"the block trisolve runs on CPU or CUDA, not "
                         f"{b.device}")
    if bs > K8_MAX_BS or (p + 1) * bs * plan.dinv.element_size() \
            > K8_SHARED_BYTES:
        raise ValueError(f"K8 takes bs <= {K8_MAX_BS} and (p + 1)·bs "
                         f"values within {K8_SHARED_BYTES} bytes; got "
                         f"bs = {bs}, p = {p}")
    if not (plan.s_hat.is_contiguous() and plan.dinv.is_contiguous()):
        raise ValueError("K8 takes contiguous plan blocks")
    bd = b.to(dt).contiguous()
    x = torch.empty(n, dtype=dt, device=b.device)
    u = torch.empty(nb * bs if p else 0, dtype=dt, device=b.device)
    geo = k8_launch_geometry(plan)
    fn = _k8_entry(dt)
    with torch.cuda.device(b.device):
        rc = fn(plan.s_hat.data_ptr(), plan.dinv.data_ptr(), bd.data_ptr(),
                u.data_ptr(), x.data_ptr(), n, nb, bs, p, int(plan.flip),
                geo.cluster if geo else 0,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        where = (f"the cluster launch of {geo.cluster} CTAs, {geo.stages} "
                 f"stages, {geo.smem_bytes} bytes of shared memory each"
                 if geo else "the diagonal-block launch")
        raise RuntimeError(f"K8 (block_trisolve) launch failed: {where}: "
                           f"{_k8_error(rc)}")
    block_trisolve_launches += 1
    _cuda_build.count_launch("K8", dt)
    return x.to(b.dtype)
