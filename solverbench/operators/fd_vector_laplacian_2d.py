"""``fd_vector_laplacian_2d``: b coupled fields on the 5-point stencil of
PySolvers ``examples/FDLaplacian2D.py``: A[i·b + p, j·b + q] =
L[i, j]·C[p, q], with L the m × m grid's negative Laplacian
(``fd5_laplacian_2d_rows``, rows lexicographic) and C = I + c·(1 − I),
rows node-major (unknown i·b + p is field p at node i), so that every
stencil offset holds a dense b × b block.  Written straight into CSR
arrays: scalar row (i, p) holds, for each stored L[i, j] in column order,
the b entries (j·b + q, L[i, j]·C[p, q]) in q order, which keeps every
row's columns ascending.  No COO triplets, no sort, no scipy.  A frozen
copy of the program's ``problems.fd_vector_laplacian_2d``, which
``solverbench/tests`` hold it to entry for entry at small m.  Entry keys:
``m``, ``b``, ``coupling``."""
import numpy as np

from solverbench.lib import spec as S
from solverbench.lib.csr import Csr


def build(op: dict) -> Csr:
    m, b = op["m"], op["b"]
    L = S.plugin("operators", "fd5_laplacian_2d_rows").build({"m": m})
    C = np.eye(b) + op["coupling"] * (np.ones((b, b)) - np.eye(b))
    n = L.n * b
    row_len = np.repeat(np.diff(L.indptr) * b, b)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(row_len, out=indptr[1:])
    # each slot's place in node i's run of (L entry, q) pairs, which
    # starts at b·L.indptr[i] for every one of the node's b rows
    src = np.arange(indptr[-1], dtype=np.int64)
    src -= np.repeat(indptr[:-1] - np.repeat(L.indptr[:-1] * b, b), row_len)
    e, q = np.divmod(src, b)
    del src
    # int32 column indices while n = m²·b stays below 2**31
    indices = (L.indices[e].astype(np.int64) * b + q).astype(np.int32)
    p = np.repeat(np.arange(n, dtype=np.int64) % b, row_len)
    data = L.data[e] * C[p, q]
    return Csr(indptr, indices, data)
