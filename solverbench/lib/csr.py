"""The benchmark's own sparse matrix: what an operator file builds, what
a variation hands on per solve, and what the reference multiplies."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Csr:
    """A square CSR matrix: int64 row pointers, int32 sorted column
    indices, no duplicates."""

    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray

    @property
    def n(self) -> int:
        return len(self.indptr) - 1

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    def rows(self) -> np.ndarray:
        return np.repeat(np.arange(self.n, dtype=np.int64),
                         np.diff(self.indptr))

    def diag_positions(self) -> np.ndarray:
        """The index in ``data`` of each row's diagonal entry, row order."""
        pos = np.flatnonzero(self.rows() == self.indices)
        if len(pos) != self.n:
            raise ValueError("a row has no diagonal entry")
        return pos

    def n_diagonals(self) -> int:
        return len(np.unique(self.indices.astype(np.int64) - self.rows()))

    def with_data(self, data: np.ndarray) -> "Csr":
        """The same pattern with other values."""
        return Csr(self.indptr, self.indices, data)


def from_scipy(M) -> Csr:
    M = M.tocsr()
    M.sum_duplicates()
    M.sort_indices()
    return Csr(M.indptr.astype(np.int64), M.indices.astype(np.int32),
               M.data.astype(np.float64))


def from_coo(rows, cols, vals, n) -> Csr:
    import scipy.sparse as sp
    return from_scipy(sp.coo_matrix((vals, (rows, cols)), shape=(n, n)))
