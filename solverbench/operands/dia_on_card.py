"""``dia_on_card``: the program's device ``DiaMatrix`` of the benchmark's
CSR, handed to the solver alone, with no ``HostCSR``: what a user who
assembles a stencil straight into DIA on the card holds, so that the
solver has no host matrix and builds its preconditioner from the card's
operator.

The table is made on the device in row chunks of about ``CHUNK`` entries:
each entry's offset (column − row) is found among the matrix's offsets
and its value lands at that diagonal's row, one vectorised scatter a
chunk; a first pass over the same chunks collects the offsets.  The
leading dimension is n rounded up to 32, as the program's own
``DiaMatrix.from_host_csr`` pads it."""
import numpy as np

CHUNK = 1 << 26


def _chunks(A, device):
    """(lo, hi, rows, offsets) of each row chunk, on the device."""
    import torch
    starts = np.unique(np.append(
        np.searchsorted(A.indptr, np.arange(0, A.nnz, CHUNK), side="right")
        - 1, A.n))
    for r0, r1 in zip(starts[:-1], starts[1:]):
        lo, hi = int(A.indptr[r0]), int(A.indptr[r1])
        counts = torch.as_tensor(np.diff(A.indptr[r0:r1 + 1])).to(device)
        rows = torch.repeat_interleave(
            torch.arange(int(r0), int(r1), device=device), counts,
            output_size=hi - lo)
        cols = torch.as_tensor(A.indices[lo:hi]).to(device, torch.int64)
        yield lo, hi, rows, cols - rows


def make(A, dtype: str, device: str):
    import torch

    from pysolvers_tpu_torch.sparse.device import DiaMatrix
    offsets = sorted(set().union(*(torch.unique(off).tolist()
                                   for _, _, _, off in _chunks(A, device))))
    ld = -(-max(A.n, 1) // 32) * 32
    table = torch.zeros((len(offsets), ld), dtype=getattr(torch, dtype),
                        device=device)
    known = torch.tensor(offsets, dtype=torch.int64, device=device)
    for lo, hi, rows, off in _chunks(A, device):
        vals = torch.as_tensor(A.data[lo:hi]).to(device, table.dtype)
        table[torch.searchsorted(known, off), rows] = vals
        del vals, rows, off
    return DiaMatrix(table, tuple(int(o) for o in offsets),
                     torch.tensor(offsets, dtype=torch.int32, device=device),
                     (A.n, A.n))
