"""``rcm``: the unknowns in reverse Cuthill–McKee order (scipy's), applied
by the benchmark, so that the program is handed the ordered matrix: row
and column i of the result are row and column perm[i] of A."""
import scipy.sparse as sp
from scipy.sparse.csgraph import reverse_cuthill_mckee

from solverbench.lib.csr import Csr, from_scipy


def apply(A: Csr) -> Csr:
    M = sp.csr_matrix((A.data, A.indices, A.indptr), shape=(A.n, A.n))
    perm = reverse_cuthill_mckee(M, symmetric_mode=True)
    return from_scipy(M[perm][:, perm])
