"""``host_csr_with_bws_pack``: the (HostCSR, BwsMatrix) pair of the
program's unstructured lane, the pack made on the device in identity order
(``use_rcm=False``) from the benchmark's ordered matrix; an AMG with
``matrix_format="bws"`` reuses it as its fine level (K2)."""
import numpy as np


def make(A, dtype: str, device: str):
    from pysolvers_tpu_torch.sparse.bws import BwsMatrix
    from pysolvers_tpu_torch.sparse.host import HostCSR
    H = HostCSR(A.indptr, A.indices, A.data.astype(np.dtype(dtype)),
                (A.n, A.n))
    return H, BwsMatrix.from_host_csr(H, dtype=np.dtype(dtype),
                                      use_rcm=False, device=device)
