"""``fd5_laplacian_2d_rows``: the matrix of ``fd5_laplacian_2d`` (the
5-point negative Laplacian of PySolvers ``examples/FDLaplacian2D.py`` on an
m × m interior grid, rows lexicographic), written row by row straight into
CSR arrays: no COO triplets, no sort, no scipy.  Each row's five slots
(i-1, j), (i, j-1), (i, j), (i, j+1), (i+1, j), in column order, are kept
where the neighbour lies inside the grid; the kept slots, row after row,
are the CSR arrays.  At m = 10239 (n = 104,837,121, nnz = 524,144,649)
that is one masked pass over each output array.  ``solverbench/tests``
hold it entry for entry to ``fd5_laplacian_2d`` at small m.  Entry keys:
``m``."""
import numpy as np

from solverbench.lib.csr import Csr


def build(op: dict) -> Csr:
    m = op["m"]
    n = m * m
    h = 1.0 / (m + 1)
    s = 1.0 / (h * h)
    i = np.arange(m)
    kept = np.empty((n, 5), dtype=bool)
    kept[:, 0] = np.repeat(i > 0, m)
    kept[:, 1] = np.tile(i > 0, m)
    kept[:, 2] = True
    kept[:, 3] = np.tile(i < m - 1, m)
    kept[:, 4] = np.repeat(i < m - 1, m)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(kept.sum(axis=1), out=indptr[1:])
    # column indices below 2**31 up to m = 46340
    cols = (np.arange(n, dtype=np.int32)[:, None]
            + np.array([-m, -1, 0, 1, m], dtype=np.int32))
    indices = cols[kept]
    del cols
    slot_values = np.array([-s, -s, 4.0 * s, -s, -s])
    data = np.broadcast_to(slot_values, (n, 5))[kept]
    return Csr(indptr, indices, data)
