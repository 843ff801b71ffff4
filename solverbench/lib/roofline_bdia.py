"""The least bytes and operations of one planar block-DIA product
(``BdiaMatrix``, kernel K4), and the products a PCG solve makes.

Bytes: each input read once and the output written once: the D block
diagonals of nb dense b × b blocks, x and y of b·nb entries:
(D·b² + 2b)·nb·w.  Operations: 2 per stored block entry, 2·D·b²·nb, far
under the byte bound.  The card's peaks are ``lib/roofline.py``'s."""
from __future__ import annotations

from .roofline import HBM_BYTES_PER_S, PEAK_FLOPS


def bdia_spmv_bytes(nb: int, b: int, n_offsets: int, word: int = 8) -> int:
    return (n_offsets * b * b + 2 * b) * nb * word


def bdia_spmv_bound_s(nb: int, b: int, n_offsets: int,
                      word: int = 8) -> float:
    """The least seconds one product can take on the card."""
    dtype = "float64" if word == 8 else "float32"
    return max(bdia_spmv_bytes(nb, b, n_offsets, word) / HBM_BYTES_PER_S,
               2.0 * n_offsets * b * b * nb / PEAK_FLOPS[dtype])


def pcg_products(iters: int) -> int:
    """The operator products of one PCG solve of ``iters`` iterations
    from x0 (``cg_solve``): the initial residual b − A·x0, which is
    computed even for x0 = 0, and one an iteration."""
    return iters + 1
