"""``fd5_laplacian_2d``: the 5-point negative Laplacian, (1/h²)·(4, −1, −1,
−1, −1), on an m × m interior grid of the unit square with homogeneous
Dirichlet conditions, rows lexicographic (PySolvers
``examples/FDLaplacian2D.py``).  A frozen copy of the program's
``problems.fd_laplacian_2d``, so that a change to the program cannot
change the inputs; ``solverbench/tests`` hold it to the program's at small
sizes.  Entry keys: ``m``."""
import numpy as np

from solverbench.lib.csr import Csr, from_coo


def build(op: dict) -> Csr:
    m = op["m"]
    h = 1.0 / (m + 1)
    s = 1.0 / (h * h)
    ii, jj = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
    ii, jj = ii.ravel(), jj.ravel()
    g = ii * m + jj
    rows, cols, vals = [g], [g], [np.full(m * m, 4.0 * s)]
    for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        ni, nj = ii + di, jj + dj
        ok = (ni >= 0) & (ni < m) & (nj >= 0) & (nj < m)
        rows.append(g[ok])
        cols.append((ni * m + nj)[ok])
        vals.append(np.full(int(ok.sum()), -s))
    return from_coo(np.concatenate(rows), np.concatenate(cols),
                    np.concatenate(vals), m * m)
