"""ILU(t) and IC(t) incomplete factorizations and their device applies.

Port of ``pysolvers_tpu/linear/ilu.py`` (reference SuperLU ``spilu``
delegation, ILUTPreconditioner.py:51-53 and ICPreconditioner.py:40-56).
The factorization runs on the host, as in the reference: the row-wise ILUT
of the shared native library (``utils/native.py::ilut``, the same code the
JAX package calls, so the factors are bit-equal), with the pure-Python
fallback copied.  ``ict_factor`` scales the no-pivot U into L = (D^{-1/2}
U)ᵀ.  The apply runs on the preconditioner's device, by ``trisolve_mode``:

* ``"block"`` — exact block-banded solves (``ops/block_trisolve.py``:
  kernel K8 on CUDA, one launch per factor), the plans built in the
  factorization's dtype (f64 natively, f32 on the mixed route) or in the
  ``apply_dtype`` that ``form()`` is given (the block lane's IC factors in
  f32 and applies to f64 vectors in f64, as the level solves promote);
* ``"level"`` — exact: two level-scheduled triangular solves
  (``ops/trisolve.py::trisolve``);
* ``"jacobi"`` — ``sweeps`` Jacobi sweeps per factor
  (``trisolve_jacobi``);
* ``"jacobi_bws"`` — the same sweeps, each product with the strict factor
  packed as an f32 ``BwsMatrix`` (kernel K2 on CUDA, its layout built on
  the card).  A factor that does not pack, or has a zero pivot, raises on
  the card; on the CPU both factors take ``"jacobi"``, as in the JAX
  package.  One deviation: a factor with no off-diagonal entry (ILUT's L
  on the FD stencils, whose multipliers all fall under the drop threshold)
  is solved exactly by its diagonal with no product, where the JAX package
  fails to pack it and degrades both factors;
* ``"auto"`` — ``"block"`` on a CUDA device, as the JAX package's "auto"
  on its accelerator, and ``"level"`` on the CPU, as there.

A factor that does not fit the block path (block reach above ``max_p`` =
4, or dense blocks above 2 GiB) degrades with a warning, as in the JAX
package: "auto" to "jacobi_bws" (whose card path raises where a factor
does not pack); an explicit "block" to "level" on the CPU, and on the card
it raises, naming the modes to pass, rather than run torch's level loop
unasked.  The fill-budget search of ``drop_scale="auto"``
(``_resolve_drop_scale``) runs exactly where the resolved mode is "block",
whose cost grows with the factor's bandwidth and not its fill.

Not ported: ``prep()`` and the one-dispatch fused setup (``ops/fuse.py``
is on the do-not-port list), and with them the ``_factor_cache`` that
``prep()`` left for ``form()``.
"""
from __future__ import annotations

import bisect
import warnings
from typing import Tuple

import numpy as np
import torch

from ..ops.block_trisolve import block_trisolve, build_block_trisolve_plan_pair
from ..ops.bws_spmv import bws_spmv
from ..ops.trisolve import build_trisolve_plan, trisolve, trisolve_jacobi
from ..sparse.bws import BwsMatrix
from ..sparse.device import resolve_device
from ..sparse.host import HostCSR
from .preconditioner import Preconditioner, PreconditionerType

TRISOLVE_MODES = ("auto", "level", "jacobi", "jacobi_bws", "block")


def _resolve_trisolve_mode(mode: str, device=None) -> str:
    """"auto" is "block" on a CUDA device and "level" elsewhere (the
    device as ``resolve_device`` reads it); unknown names raise."""
    if mode not in TRISOLVE_MODES:
        raise ValueError(f"unknown trisolve_mode {mode!r}; expected one of "
                         f"{TRISOLVE_MODES}")
    if mode != "auto":
        return mode
    return "block" if resolve_device(device).type == "cuda" else "level"


def _block_plan_pair(T_lo: HostCSR, T_up: HostCSR, unit_lo: bool,
                     unit_up: bool, dtype, device):
    """Both factors' block plans on ``device``, or None if either factor
    does not qualify (found on the host, before anything is uploaded)."""
    try:
        return build_block_trisolve_plan_pair(T_lo, T_up, unit_lo=unit_lo,
                                              unit_up=unit_up, dtype=dtype,
                                              device=device)
    except ValueError:
        return None


def _degrade_from_block(requested_mode: str, what: str, device) -> str:
    """The fallback when the exact block path does not apply: "auto" keeps
    the fast approximate K2 sweeps, with a warning; an explicit "block"
    asked for exactness and gets the exact level-scheduled solves on the
    CPU, with a warning, and a ValueError on the card."""
    reason = (f"{what}: factor not banded enough for the block trisolve "
              "(block reach above 4, or dense blocks above 2 GiB)")
    if requested_mode == "block":
        if torch.device(device).type != "cpu":
            raise ValueError(f"{reason}; pass trisolve_mode='level' (exact) "
                             "or 'jacobi_bws' (approximate, K2 sweeps)")
        warnings.warn(f"{reason}; using exact level-scheduled solves",
                      stacklevel=3)
        return "level"
    warnings.warn(f"{reason}; degrading to approximate Jacobi/BWS sweeps "
                  "(pass trisolve_mode='level' for exact)", stacklevel=3)
    return "jacobi_bws"


def _block_pair_apply(state, v):
    """M^{-1} v by the two exact block solves of the (lower, upper) plan
    pair."""
    plan_lo, plan_up = state
    return block_trisolve(plan_up, block_trisolve(plan_lo, v))


def _bws_sweep_solver(T: HostCSR, unit_diag: bool, sweeps: int, dtype,
                      device, name: str = "the factor"):
    """Approximate triangular solve as Jacobi sweeps whose products run on
    the strict factor packed as a BwsMatrix (K2 on CUDA):
    x_{k+1} = D^{-1}(b - N x_k), T = D + N.  Returns the apply.  Raises
    ValueError on a zero pivot, or if the strict factor does not pack (it
    must be banded enough for BWS windows); both are found on the host,
    before anything is uploaded."""
    n = T.shape[0]
    rows, cols, vals = T.to_coo()
    off = rows != cols
    if unit_diag:
        dinv = np.ones(n, dtype=dtype)
    else:
        d = T.diagonal()
        if (d == 0).any():
            raise ValueError(f"{name} has a zero pivot in row "
                             f"{int(np.flatnonzero(d == 0)[0])}")
        dinv = (1.0 / d).astype(dtype)
    N = None
    if off.any():
        strict = HostCSR.from_coo(rows[off], cols[off], vals[off], T.shape,
                                  sum_duplicates=False)
        # the factor's own ordering (bandedness comes from the matrix);
        # bf16-grade selects suffice for a preconditioner; group_rows
        # pinned to 32 as in the JAX package
        try:
            N = BwsMatrix.from_host_csr(strict, dtype=dtype, use_rcm=False,
                                        fast_select=True, group_rows=32,
                                        gt="auto", device=device)
        except ValueError as e:
            raise ValueError(f"{name} does not pack as BWS ({e})") from e
    dinv_t = torch.as_tensor(dinv, device=device)
    if N is None:
        return lambda b: dinv_t * b       # diagonal: exact, no product

    def solve_fn(b):
        x = dinv_t * b
        for _ in range(sweeps - 1):
            x = dinv_t * (b - bws_spmv(N, x.to(N.dtype)))
        return x

    return solve_fn


def ilut_factor(A: HostCSR, drop_tol: float = 1e-3, fill_factor: float = 15.0
                ) -> Tuple[HostCSR, HostCSR]:
    """Row-wise ILUT.  Returns (L unit-lower with implicit diagonal stored
    explicitly as 1.0, U upper incl. diagonal) with A ≈ L·U.

    Fast path: native C++ (utils/native.py); fallback: pure Python below.
    """
    n = A.shape[0]
    indptr, indices, data = A.indptr, A.indices, A.data

    from ..utils import native
    res = native.ilut(indptr, indices, data, n, drop_tol, fill_factor)
    if res is not None:
        (Lp, Li, Lx), (Up, Ui, Ux) = res
        dt = A.data.dtype
        return (HostCSR(Lp, Li, Lx.astype(dt), (n, n)),
                HostCSR(Up, Ui, Ux.astype(dt), (n, n)))

    # U rows stored as running arrays for fast lookup during elimination
    U_cols: list = [None] * n
    U_vals: list = [None] * n
    U_diag = np.zeros(n, dtype=np.float64)
    L_cols: list = [None] * n
    L_vals: list = [None] * n

    for i in range(n):
        lo, hi = indptr[i], indptr[i + 1]
        cols_i = indices[lo:hi]
        vals_i = data[lo:hi].astype(np.float64)
        row_nnz = hi - lo
        # relative drop threshold for this row (Saad: tau * ||row||)
        tau_i = drop_tol * np.linalg.norm(vals_i) if row_nnz else 0.0
        p = max(int(fill_factor * row_nnz), row_nnz) if row_nnz else 1

        w = dict(zip(cols_i.tolist(), vals_i.tolist()))
        # eliminate in ascending column order among k < i
        lower_ks = sorted(c for c in w if c < i)
        lpos = 0
        lelems = {}
        while lpos < len(lower_ks):
            k = lower_ks[lpos]
            lpos += 1
            wk = w.pop(k)
            piv = U_diag[k]
            if piv == 0.0:
                continue
            lik = wk / piv
            if abs(lik) <= tau_i:
                continue
            lelems[k] = lik
            uc, uv = U_cols[k], U_vals[k]
            for c, v in zip(uc, uv):
                if c == k:
                    continue
                upd = w.get(c)
                if upd is None:
                    nv = -lik * v
                    if abs(nv) > tau_i:
                        w[c] = nv
                        if c < i:
                            # new fill-in in the lower part: insert in order
                            bisect.insort(lower_ks, c, lo=lpos)
                else:
                    w[c] = upd - lik * v

        # split/drop
        diag = w.pop(i, 0.0)
        if diag == 0.0:
            # zero-pivot guard (mirrors SuperLU behavior loosely)
            diag = tau_i if tau_i > 0 else 1e-12
        upper = [(c, v) for c, v in w.items() if c > i and abs(v) > tau_i]
        lower = [(c, v) for c, v in lelems.items()]
        # fill cap: keep p largest by magnitude each side
        if len(upper) > p:
            upper.sort(key=lambda cv: -abs(cv[1]))
            upper = upper[:p]
        if len(lower) > p:
            lower.sort(key=lambda cv: -abs(cv[1]))
            lower = lower[:p]
        upper.sort()
        lower.sort()
        L_cols[i] = [c for c, _ in lower] + [i]
        L_vals[i] = [v for _, v in lower] + [1.0]
        U_cols[i] = [i] + [c for c, _ in upper]
        U_vals[i] = [diag] + [v for _, v in upper]
        U_diag[i] = diag

    def pack(cols_l, vals_l):
        lens = np.array([len(c) for c in cols_l], dtype=np.int64)
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens, out=indptr[1:])
        return HostCSR(indptr,
                       np.concatenate([np.asarray(c, np.int32) for c in cols_l]),
                       np.concatenate([np.asarray(v, np.float64) for v in vals_l]),
                       (n, n))

    return pack(L_cols, L_vals), pack(U_cols, U_vals)


def ict_factor(A: HostCSR, drop_tol: float = 1e-3, fill_factor: float = 15.0
               ) -> HostCSR:
    """Incomplete Cholesky with threshold: A ≈ L·Lᵀ, from the no-pivot
    incomplete LU scaled as L = (D^{-1/2} U)ᵀ (the reference's route,
    ICPreconditioner.py:49-56)."""
    _, U = ilut_factor(A, drop_tol=drop_tol, fill_factor=fill_factor)
    d = U.diagonal()
    if (d <= 0).any():
        raise ValueError("IC(t): matrix is not positive definite enough; "
                         "negative pivot encountered")
    Uscaled = U.scale_rows(1.0 / np.sqrt(d))
    return Uscaled.transpose()


def _check_fill(A: HostCSR, L: HostCSR, U: HostCSR, fill_factor: float,
                name: str) -> None:
    """Guard against fill explosion: the per-row cap bounds each row at
    fill_factor·nnz(A_row), so total factor fill beyond
    2·fill_factor·nnz(A) + 2n signals a broken drop rule."""
    total = L.nnz + U.nnz
    cap = 2.0 * fill_factor * A.nnz + 2 * A.shape[0]
    if total > cap:
        raise RuntimeError(
            f"{name} factor fill exploded: nnz(L)+nnz(U)={total} exceeds "
            f"2*fill_factor*nnz(A)+2n={cap:.0f}; raise drop_tol or lower "
            f"fill_factor")


# ---------------------------------------------------------------------------
# Drop scale
# ---------------------------------------------------------------------------
#
# Saad's relative threshold drops more than SuperLU's rule at the same
# nominal drop_tol.  "auto" scales the threshold so that the factor uses a
# set fraction of the fill budget the caller granted (fill_factor·nnz(A)),
# where fill costs nothing: the block apply's cost follows the factor's
# bandwidth, not its nonzeros.  Everywhere else it factors once at the seed.
_AUTO_SEED = 0.1          # search seed
# target total factor nnz as a fraction of fill_factor·nnz(A)
_AUTO_BUDGET_FRAC = 0.52
_SCALE_CACHE: dict = {}   # (kind, drop_tol, fill, shape, nnz) -> scale;
                          # at most 65 entries, the oldest dropped first


def _resolve_drop_scale(kind: str, A: HostCSR, drop_tol: float,
                        fill_factor: float, drop_scale, factor_fn,
                        fill_is_free: bool = True):
    """Factor at the resolved drop threshold; 1-4 factorizations cold.

    ``factor_fn(eff_drop) -> (result, total_nnz)``.  A float
    ``drop_scale`` factors once at drop_tol·drop_scale; "auto" without
    ``fill_is_free`` once at drop_tol·_AUTO_SEED.  "auto" with it factors
    at the seed, and while the factor holds under 80 % of the target
    (_AUTO_BUDGET_FRAC·fill_factor·nnz(A)) takes at most three more steps
    along the matrix's own measured fill slope alpha = d log nnz / d
    log(1/drop) (the first probe a fixed 4x deeper; each step at most 64x;
    a flat slope stops), as the JAX package does.  The resolved scale is
    cached on the matrix signature, so a warm re-setup factors once.
    """
    if drop_scale != "auto":
        res, _ = factor_fn(drop_tol * float(drop_scale))
        return res
    if not fill_is_free:
        res, _ = factor_fn(drop_tol * _AUTO_SEED)
        return res
    key = (kind, float(drop_tol), float(fill_factor), A.shape, A.nnz)
    s = _SCALE_CACHE.get(key)
    if s is not None:
        res, _ = factor_fn(drop_tol * s)
        return res
    target = _AUTO_BUDGET_FRAC * fill_factor * A.nnz
    s = _AUTO_SEED
    res, total = factor_fn(drop_tol * s)
    s_prev, total_prev = None, None
    for _ in range(3):
        if total >= 0.8 * target or s <= _AUTO_SEED / 4096.0:
            break
        if total_prev is None or total <= total_prev or s >= s_prev:
            s_next = s / 4.0
        else:
            alpha = float(np.log(total / total_prev)
                          / np.log(s_prev / s))
            alpha = min(max(alpha, 0.05), 4.0)       # sane slope window
            s_next = max(s * (total / target) ** (1.0 / alpha),
                         s / 64.0)
        res_n, total_n = factor_fn(drop_tol * s_next)
        if total_n <= total:
            # flat slope: the factor already holds every entry the rule
            # can keep
            break
        s_prev, total_prev = s, total
        s, total, res = s_next, total_n, res_n
    if len(_SCALE_CACHE) > 64:
        _SCALE_CACHE.pop(next(iter(_SCALE_CACHE)))
    _SCALE_CACHE[key] = s
    return res


# ---------------------------------------------------------------------------
# Preconditioner types (API parity with the reference's factories)
# ---------------------------------------------------------------------------

def _factor_apply(lo: HostCSR, up: HostCSR, unit_lo: bool, mode: str,
                  sweeps: int, dtype, device):
    """v -> up⁻¹(lo⁻¹ v) on ``device`` by ``mode`` (resolved; "block" is
    the caller's)."""
    if mode == "jacobi_bws":
        try:
            sl = _bws_sweep_solver(lo, unit_lo, sweeps, np.float32, device,
                                   "the lower factor")
            su = _bws_sweep_solver(up, False, sweeps, np.float32, device,
                                   "the upper factor")
            return lambda v: su(sl(v))
        except ValueError as e:
            if torch.device(device).type != "cpu":
                # the card runs K2's sweeps or none: no torch sweeps here
                raise ValueError(f"trisolve_mode='jacobi_bws': {e}; pass "
                                 f"trisolve_mode='jacobi' or 'level'") from e
            # the CPU keeps the JAX package's degrade: "jacobi" for both
    # level plans only on the paths that use them
    plan_lo = build_trisolve_plan(lo, lower=True, unit_diag=unit_lo,
                                  dtype=dtype, device=device)
    plan_up = build_trisolve_plan(up, lower=False, dtype=dtype,
                                  device=device)
    if mode in ("jacobi", "jacobi_bws"):
        return lambda v: trisolve_jacobi(
            plan_up, trisolve_jacobi(plan_lo, v, sweeps), sweeps)
    return lambda v: trisolve(plan_up, trisolve(plan_lo, v))


class _FactorPreconditionerType(PreconditionerType):
    """What ILU(t) and IC(t) share: the arguments, the drop scale and the
    apply by mode.  Subclasses give ``kind``, ``_factor_nnz`` (the factor
    and its total nnz at a drop threshold) and ``_pair`` (lower factor,
    upper factor, unit lower diagonal)."""

    kind = ""
    name = ""

    def __init__(self, drop_tol: float = 1e-3, fill_factor: float = 15.0,
                 side: str = "right", trisolve_mode: str = "auto",
                 sweeps: int = 10, drop_scale="auto"):
        _resolve_trisolve_mode(trisolve_mode, "cpu")
        self.drop_tol = drop_tol
        self.fill_factor = fill_factor
        self.drop_scale = drop_scale
        self.side = side
        self.trisolve_mode = trisolve_mode
        self.sweeps = sweeps

    def _factor(self, A_host: HostCSR, device=None):
        """The factor(s) at the resolved drop scale; the fill-budget
        search runs where the mode resolves to "block" on ``device``."""
        return _resolve_drop_scale(
            self.kind, A_host, self.drop_tol, self.fill_factor,
            self.drop_scale, lambda eff: self._factor_nnz(A_host, eff),
            fill_is_free=_resolve_trisolve_mode(
                self.trisolve_mode, device) == "block")

    def form(self, A_host: HostCSR, A_dev=None, device=None,
             apply_dtype=None) -> Preconditioner:
        """``apply_dtype``: the block plans' dtype where it is not the
        factor's (the factor's values are exact in a wider one)."""
        device = resolve_device(device)
        f = self._factor(A_host, device)
        lo, up, unit_lo = self._pair(f)
        _check_fill(A_host, lo, up, self.fill_factor, self.name)
        dtype = A_host.data.dtype
        mode = _resolve_trisolve_mode(self.trisolve_mode, device)
        if mode == "block":
            # the plans run in the solve's dtype: an f32 plan inside a
            # native f64 solve makes the apply inexact at ~eps32, which
            # non-flexible GMRES reports as a true-residual mismatch; the
            # f32 route is the mixed one, which forms on an f32 host matrix
            pair = _block_plan_pair(lo, up, unit_lo, False,
                                    apply_dtype or dtype, device)
            if pair is not None:
                prec = self._wrap(lambda v: _block_pair_apply(pair, v))
                prec.state = pair
                return prec
            mode = _degrade_from_block(self.trisolve_mode, self.name, device)
        return self._wrap(_factor_apply(lo, up, unit_lo, mode, self.sweeps,
                                        dtype, device))


class ILUTPreconditionerType(_FactorPreconditionerType):
    """ILU(t) preconditioner; reference Left/RightILUT
    (ILUTPreconditioner.py:10-31, defaults drop_tol=1e-3, fill_factor=15).

    ``drop_scale``: "auto" (default; see ``_resolve_drop_scale``) or a
    float multiplying drop_tol (1.0 = the raw Saad rule).
    ``trisolve_mode``: see the module docstring; ``sweeps`` for the Jacobi
    modes.
    """

    kind, name = "ilut", "ILUT"

    def _factor_nnz(self, A_host, eff):
        L, U = ilut_factor(A_host, eff, self.fill_factor)
        return (L, U), L.nnz + U.nnz

    def _pair(self, f):
        return f[0], f[1], True


class ICPreconditionerType(_FactorPreconditionerType):
    """IC(t) preconditioner (SPD); reference RightIC
    (ICPreconditioner.py:20-29): apply = L⁻ᵀ (L⁻¹ v).  Arguments as for
    ILUTPreconditionerType; the block mode solves the generic (L, Lᵀ)
    pair."""

    kind, name = "ic", "IC"

    def _factor_nnz(self, A_host, eff):
        Lc = ict_factor(A_host, eff, self.fill_factor)
        return Lc, 2 * Lc.nnz

    def _pair(self, Lc):
        return Lc, Lc.transpose(), False
