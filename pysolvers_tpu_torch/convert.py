"""Carry solver state across from the JAX package.

The solver's "weights" are its device operators and the AMG hierarchy.
These functions take numpy arrays only (``np.asarray`` of the JAX
package's leaves — this package never imports jax) and build the port's
objects on ``device`` (None: the current CUDA device; it raises where there
is none, so CPU callers pass ``device="cpu"``), so both
packages can run the same operators.

A JAX ``DiaTiled`` is flattened with ``.to_dia()`` before its diagonals are
taken; padded diagonals (leading dimension ``ld >= n_rows``) are accepted
as they are.  A JAX ``BwsMatrix`` carries across through its tables and
static fields (``bws_from_arrays``); its ``margin_blocks`` (always 0)
has no counterpart here.  A JAX ``BdiaMatrix`` carries across through
``np.asarray(A.planes)`` and its static fields (``bdia_from_arrays``).
A JAX ``GridDiaMatrix`` carries across through ``np.asarray(A.diags)``
(its padded (D, mr_pad, mc_o) table), ``pairs`` and ``dims``
(``grid_dia_from_arrays``); a JAX ``GridHierarchy`` level by level
(``grid_hierarchy_from_arrays``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .linear.amg import DeviceHierarchy, DeviceLevel
from .linear.gmg_grid import GridHierarchy, GridLevel
from .ops.grid_spmv import GridDiaMatrix
from .ops.trisolve import TriSolvePlan
from .sparse.bdia import BdiaMatrix
from .sparse.bws import BwsMatrix
from .sparse.device import DiaMatrix, EllMatrix, resolve_device


def dia_from_arrays(diags, offsets, shape, device=None) -> DiaMatrix:
    """DiaMatrix from a (D, ld) diagonal table and its D offsets."""
    return DiaMatrix.from_numpy(np.array(diags), offsets, shape,
                                device=device)


def ell_from_arrays(data, cols, shape, n_cols_pad: int,
                    device=None) -> EllMatrix:
    """EllMatrix from padded (n_rows_pad, k) value and column tables."""
    device = resolve_device(device)
    return EllMatrix(torch.as_tensor(np.array(data), device=device),
                     torch.as_tensor(np.array(cols, dtype=np.int32),
                                     device=device),
                     tuple(int(s) for s in shape), int(n_cols_pad))


def bws_from_arrays(delta, data, lidx, perm, iperm, base, shape,
                    win_blocks: int, group_rows: int, s_classes, gt: int,
                    fast_select: bool = False, device=None) -> BwsMatrix:
    """BwsMatrix from the JAX pack's tables (numpy) and static fields."""
    return BwsMatrix.from_numpy(delta, data, lidx, perm, iperm, base, shape,
                                win_blocks, group_rows, s_classes, gt,
                                fast_select, device=device)


def bdia_from_arrays(planes, offsets, shape, b: int,
                     device=None) -> BdiaMatrix:
    """BdiaMatrix from a (D·b, b, nb_pad) plane table, its D block offsets,
    the scalar shape and the block size."""
    return BdiaMatrix.from_numpy(np.array(planes), offsets, shape, b,
                                 device=device)


def grid_dia_from_arrays(diags, pairs, dims, device=None) -> GridDiaMatrix:
    """GridDiaMatrix from a (D, >= mr, >= mc) grid table (the JAX package
    pads it to (D, mr_pad, mc_o); its [:, :mr, :mc] part is kept), the D
    (dr, dc) pairs and the grid dims (mr, mc)."""
    return GridDiaMatrix.from_numpy(np.asarray(diags), pairs, dims,
                                    device=device)


def trisolve_plan_from_arrays(ell_data, ell_cols, diag, levels, lower: bool,
                              device=None) -> TriSolvePlan:
    """TriSolvePlan from the JAX plan's four tables and its orientation."""
    return TriSolvePlan.from_numpy(np.array(ell_data), np.array(ell_cols),
                                   np.array(diag), np.array(levels),
                                   lower, device=device)


def _operator(op: Optional[dict], device):
    """A DIA operator is {"diags", "offsets", "shape"}; a grid-DIA operator
    {"diags", "pairs", "dims"}; an ELL operator {"data", "cols", "shape",
    "n_cols_pad"}; a BWS operator holds the keyword arguments of
    ``bws_from_arrays`` (its "lidx" marks it)."""
    if op is None:
        return None
    if "pairs" in op:
        return grid_dia_from_arrays(op["diags"], op["pairs"], op["dims"],
                                    device)
    if "diags" in op:
        return dia_from_arrays(op["diags"], op["offsets"], op["shape"],
                               device)
    if "lidx" in op:
        return bws_from_arrays(device=device, **op)
    return ell_from_arrays(op["data"], op["cols"], op["shape"],
                           op["n_cols_pad"], device)


def _plan(plan, device):
    """None, one plan dict ("gs"), or a (lower, upper) pair ("sgs"); a plan
    dict holds the keyword arguments of ``trisolve_plan_from_arrays``."""
    if plan is None:
        return None
    if isinstance(plan, dict):
        return trisolve_plan_from_arrays(device=device, **plan)
    return tuple(_plan(p, device) for p in plan)


def hierarchy_from_arrays(levels: Sequence[dict], A0_inv, smoother: str,
                          nu_pre: int, nu_post: int,
                          device=None) -> DeviceHierarchy:
    """DeviceHierarchy from per-level dicts, coarsest first.

    Each level dict has the keys "A", "P", "R" (operator dicts as in
    ``_operator``, or None), "dinv" (array or None) and "gs_plan" (as in
    ``_plan``), and optionally "cheb" ((theta, delta) or None)."""
    device = resolve_device(device)
    out = []
    for lev in levels:
        dinv = lev["dinv"]
        out.append(DeviceLevel(
            _operator(lev["A"], device),
            None if dinv is None else torch.as_tensor(np.array(dinv),
                                                      device=device),
            _plan(lev["gs_plan"], device),
            _operator(lev["P"], device),
            _operator(lev["R"], device),
            _cheb(lev.get("cheb"))))
    return DeviceHierarchy(out, torch.as_tensor(np.array(A0_inv),
                                                device=device),
                           smoother, int(nu_pre), int(nu_post))


def _cheb(cheb):
    return None if cheb is None else tuple(float(v) for v in cheb)


def grid_hierarchy_from_arrays(levels: Sequence[dict], A0_inv, ms, ndim: int,
                               smoother: str, nu_pre: int, nu_post: int,
                               device=None) -> GridHierarchy:
    """GridHierarchy from per-level dicts, coarsest first (the first one
    unused, as in the JAX package).  Each level dict has the keys "A" (a
    DIA or grid-DIA operator dict as in ``_operator``, or None), "dinv"
    (array or None) and "cheb" ((theta, delta) or None)."""
    device = resolve_device(device)
    out = [GridLevel(_operator(lev["A"], device),
                     None if lev["dinv"] is None
                     else torch.as_tensor(np.array(lev["dinv"]),
                                          device=device),
                     _cheb(lev["cheb"]))
           for lev in levels]
    return GridHierarchy(out, torch.as_tensor(np.array(A0_inv),
                                              device=device),
                         tuple(int(m) for m in ms), int(ndim), smoother,
                         int(nu_pre), int(nu_post))
