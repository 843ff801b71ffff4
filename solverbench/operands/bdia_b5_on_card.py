"""``bdia_b5_on_card``: the program's ``BdiaMatrix`` of the benchmark's CSR
with 5 × 5 blocks, packed on the host by ``BdiaMatrix.from_host_csr`` from
a ``HostCSR`` in the run's dtype and uploaded to the device, as a user who
holds the system as a host CSR packs it.  The block size is this file's:
``make`` is handed no configuration."""
import numpy as np

B = 5


def make(A, dtype: str, device: str):
    from pysolvers_tpu_torch.sparse.bdia import BdiaMatrix
    from pysolvers_tpu_torch.sparse.host import HostCSR
    H = HostCSR(A.indptr, A.indices, A.data.astype(np.dtype(dtype)),
                (A.n, A.n))
    return BdiaMatrix.from_host_csr(H, B, device=device)
