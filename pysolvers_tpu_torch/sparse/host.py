"""Host-side sparse containers and conversions (numpy only).

Copied from ``pysolvers_tpu/sparse/host.py``, code unchanged: importing any
``pysolvers_tpu`` submodule runs that package's ``__init__``, which imports
jax, and the port must run without it.

Setup-phase representation: everything data-dependent (factorization,
aggregation, partitioning, format conversion) happens here on host, producing
static-shaped device-ready buffers.  Mirrors the capability surface of the
reference's use of scipy.sparse CSR (see the reference's
PySolvers/Linear/IterativeLinearSolver.py:94-106) without depending on scipy.
"""
from __future__ import annotations

import dataclasses
import numpy as np

# structure-keyed symmetric-permutation plans (HostCSR.permute_symmetric)
_PERM_CACHE: dict = {}


@dataclasses.dataclass
class HostCSR:
    """Compressed sparse row matrix on host (numpy buffers).

    indptr:  (n_rows+1,) int64
    indices: (nnz,)      int32  column indices, sorted within each row
    data:    (nnz,)      float
    shape:   (n_rows, n_cols)
    """

    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    shape: tuple

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def dtype(self):
        return self.data.dtype

    # ---------------- construction ----------------

    @staticmethod
    def from_coo(rows, cols, vals, shape, sum_duplicates: bool = True) -> "HostCSR":
        """Build CSR from COO triplets (vectorized lexsort, no scipy)."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        if sum_duplicates and len(rows) > 0:
            # collapse identical (row, col) runs of the sorted stream —
            # one reduceat over run starts (np.unique+add.at cost ~5x
            # more at 1e7+ nnz, dominating large FEM assemblies)
            same = (rows[1:] == rows[:-1]) & (cols[1:] == cols[:-1])
            if same.any():
                first = np.empty(len(rows), dtype=bool)
                first[0] = True
                first[1:] = ~same
                starts = np.flatnonzero(first)
                vals = np.add.reduceat(vals, starts)
                rows, cols = rows[starts], cols[starts]
        indptr = np.zeros(shape[0] + 1, dtype=np.int64)
        np.cumsum(np.bincount(rows, minlength=shape[0]), out=indptr[1:])
        return HostCSR(indptr, cols.astype(np.int32), vals, tuple(shape))

    @staticmethod
    def from_dense(a: np.ndarray, tol: float = 0.0) -> "HostCSR":
        a = np.asarray(a)
        mask = np.abs(a) > tol
        rows, cols = np.nonzero(mask)
        return HostCSR.from_coo(rows, cols, a[rows, cols], a.shape)

    @staticmethod
    def eye(n: int, dtype=np.float64) -> "HostCSR":
        return HostCSR(
            np.arange(n + 1, dtype=np.int64),
            np.arange(n, dtype=np.int32),
            np.ones(n, dtype=dtype),
            (n, n),
        )

    # ---------------- conversions ----------------

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.data.dtype)
        for i in range(self.n_rows):
            lo, hi = self.indptr[i], self.indptr[i + 1]
            out[i, self.indices[lo:hi]] += self.data[lo:hi]
        return out

    def to_coo(self):
        row_counts = np.diff(self.indptr)
        rows = np.repeat(np.arange(self.n_rows, dtype=np.int64), row_counts)
        return rows, self.indices.astype(np.int64), self.data

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr)

    def diagonal(self) -> np.ndarray:
        d = np.zeros(self.n_rows, dtype=self.data.dtype)
        rows, cols, vals = self.to_coo()
        on_diag = rows == cols
        d[rows[on_diag]] = vals[on_diag]
        return d

    def permute_symmetric(self, perm: np.ndarray) -> "HostCSR":
        """P·A·Pᵀ for a row/column permutation ``perm`` (new row i is old
        row perm[i]).  The reorder plan depends only on the sparsity
        structure + perm, so it is cached on a structure hash and a
        same-structure re-permute (Newton steps, repeated setups) is a
        single value gather — the symbolic/numeric split, matching
        BwsMatrix.host_pack.  Index arrays are treated as immutable."""
        perm = np.asarray(perm, dtype=np.int64)
        key = (hash(self.indptr.tobytes()), hash(self.indices.tobytes()),
               self.nnz, self.shape, hash(perm.tobytes()))
        ent = _PERM_CACHE.get(key)
        if ent is None:
            n = self.shape[0]
            from ..utils.native import csr_permute_plan
            ent = csr_permute_plan(self.indptr, self.indices, perm)
            if ent is None:         # no native lib: numpy fallback
                iperm = np.empty(n, dtype=np.int64)
                iperm[perm] = np.arange(n)
                rows, cols, _ = self.to_coo()
                r2, c2 = iperm[rows], iperm[cols]
                # single fused sort key (row-major) beats the 2-key
                # lexsort ~2x at 29M nnz; counts via bincount not add.at
                order = np.argsort(r2 * np.int64(n) + c2, kind="stable")
                indptr = np.zeros(n + 1, dtype=np.int64)
                np.cumsum(np.bincount(r2, minlength=n), out=indptr[1:])
                ent = (order, indptr, c2[order].astype(np.int32))
            if len(_PERM_CACHE) > 32:
                _PERM_CACHE.pop(next(iter(_PERM_CACHE)))
            _PERM_CACHE[key] = ent
        order, indptr, indices = ent
        return HostCSR(indptr, indices, self.data[order], self.shape)

    def transpose(self) -> "HostCSR":
        # counting-sort CSR transpose: a stable argsort on the column ids
        # groups entries by new row while keeping the old row order inside
        # each group (so new-column indices stay sorted).  O(nnz log nnz)
        # in fast C — the general lexsort+add.at route in from_coo cost
        # ~0.5 s on a 0.5M-nnz factor, this takes ~15 ms.
        n_rows, n_cols = self.shape
        rows, _, vals = self.to_coo()
        order = np.argsort(self.indices, kind="stable")
        indptr = np.zeros(n_cols + 1, dtype=np.int64)
        counts = np.bincount(self.indices, minlength=n_cols)
        np.cumsum(counts, out=indptr[1:])
        return HostCSR(indptr, rows[order].astype(np.int32), vals[order],
                       (n_cols, n_rows))

    def copy(self) -> "HostCSR":
        return HostCSR(self.indptr.copy(), self.indices.copy(), self.data.copy(),
                       self.shape)

    # ---------------- algebra (host; setup-phase only) ----------------

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """Reference-correct host SpMV (tests / setup / the mixed route's
        f64 residual oracle).  Fast path: native C++ sequential loop
        (numpy's fancy-gather + add.at route costs ~10 s at 7e6 nnz on
        slow-memory hosts); fallback: gather + reduceat over row runs."""
        out_dtype = np.result_type(self.data, x)
        from ..utils import native
        y = native.csr_matvec(self.indptr, self.indices, self.data, x)
        if y is not None:
            return y.astype(out_dtype, copy=False)
        prods = self.data * np.asarray(x)[self.indices]
        y = np.zeros(self.n_rows, dtype=out_dtype)
        nz = self.indptr[:-1] < self.indptr[1:]     # reduceat copies the
        # next element for empty segments — compute on non-empty rows only
        y[nz] = np.add.reduceat(prods, self.indptr[:-1][nz])
        return y

    def matmat(self, other: "HostCSR") -> "HostCSR":
        """Host SpGEMM (Gustavson).

        Used for Galerkin triple products R*A*P during AMG setup (the
        reference delegates this to scipy's C SpGEMM at MLHierarchy.py:54).
        Fast path: native C++ (utils/native.py); fallback: vectorized numpy.
        """
        assert self.n_cols == other.n_rows
        from ..utils import native
        res = native.spgemm(self.indptr, self.indices, self.data,
                            other.indptr, other.indices, other.data,
                            self.shape, other.shape)
        if res is not None:
            indptr, indices, data = res
            return HostCSR(indptr, indices,
                           data.astype(np.result_type(self.data, other.data),
                                       copy=False),
                           (self.n_rows, other.n_cols))
        n = self.n_rows
        out_indptr = np.zeros(n + 1, dtype=np.int64)
        out_rows_idx = []
        out_rows_val = []
        B_indptr, B_indices, B_data = other.indptr, other.indices, other.data
        for i in range(n):
            lo, hi = self.indptr[i], self.indptr[i + 1]
            if lo == hi:
                out_rows_idx.append(np.empty(0, dtype=np.int32))
                out_rows_val.append(np.empty(0, dtype=self.data.dtype))
                continue
            ks = self.indices[lo:hi]
            avals = self.data[lo:hi]
            # gather rows of B for all k at once
            starts = B_indptr[ks]
            ends = B_indptr[ks + 1]
            lens = ends - starts
            total = int(lens.sum())
            if total == 0:
                out_rows_idx.append(np.empty(0, dtype=np.int32))
                out_rows_val.append(np.empty(0, dtype=self.data.dtype))
                continue
            pos = np.repeat(starts - np.cumsum(lens) + lens, lens) + np.arange(total)
            cols = B_indices[pos]
            vals = np.repeat(avals, lens) * B_data[pos]
            uniq, inv = np.unique(cols, return_inverse=True)
            acc = np.zeros(len(uniq), dtype=vals.dtype)
            np.add.at(acc, inv, vals)
            out_rows_idx.append(uniq.astype(np.int32))
            out_rows_val.append(acc)
            out_indptr[i + 1] = len(uniq)
        np.cumsum(out_indptr, out=out_indptr)
        return HostCSR(out_indptr,
                       np.concatenate(out_rows_idx) if out_rows_idx else np.empty(0, np.int32),
                       np.concatenate(out_rows_val) if out_rows_val else np.empty(0, self.data.dtype),
                       (n, other.n_cols))

    def scale_rows(self, s: np.ndarray) -> "HostCSR":
        row_counts = np.diff(self.indptr)
        return HostCSR(self.indptr.copy(), self.indices.copy(),
                       self.data * np.repeat(s, row_counts), self.shape)

    def add(self, other: "HostCSR", alpha: float = 1.0) -> "HostCSR":
        r1, c1, v1 = self.to_coo()
        r2, c2, v2 = other.to_coo()
        return HostCSR.from_coo(
            np.concatenate([r1, r2]), np.concatenate([c1, c2]),
            np.concatenate([v1, alpha * v2]), self.shape)

    def extract_lower(self, unit_diag: bool = False) -> "HostCSR":
        """Strictly-lower + diagonal (or unit diagonal) part."""
        rows, cols, vals = self.to_coo()
        keep = cols < rows if unit_diag else cols <= rows
        L = HostCSR.from_coo(rows[keep], cols[keep], vals[keep], self.shape,
                             sum_duplicates=False)
        if unit_diag:
            n = self.n_rows
            L = L.add(HostCSR.eye(n, dtype=self.data.dtype))
        return L

    def extract_upper(self) -> "HostCSR":
        rows, cols, vals = self.to_coo()
        keep = cols >= rows
        return HostCSR.from_coo(rows[keep], cols[keep], vals[keep], self.shape,
                                sum_duplicates=False)
