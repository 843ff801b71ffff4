"""``host_csr``: the benchmark's CSR handed over as the program's
``HostCSR`` in the run's dtype; the solver lowers it itself (DIA where
banded, else ELL)."""
import numpy as np


def make(A, dtype: str, device: str):
    from pysolvers_tpu_torch.sparse.host import HostCSR
    return HostCSR(A.indptr, A.indices, A.data.astype(np.dtype(dtype)),
                   (A.n, A.n))
