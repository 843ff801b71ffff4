"""The card's peaks and the least bytes of one sparse product.

Peaks: NVIDIA's H100 SXM data sheet (700 W): HBM3 at 3.35 TB/s, 67 TFLOP/s
in float32 and 34 TFLOP/s in float64 outside the tensor cores (copied from
``pysolvers_tpu_torch/utils/profiling.py``).  A sparse product does 2
operations per stored entry, far under the byte bound, so its bound is its
bytes over the memory rate.

Bytes: each input read once and the output written once.
- ``dia``: the D stored diagonals of n entries, x and y:
  (D + 2)·n·w.
- ``csr``: the least any format can read for an unstructured matrix:
  values and int32 column indices, int32 row pointers, x and y:
  nnz·(w + 4) + 4·(n + 1) + 2·n·w.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}


def spmv_bytes(fmt: str, n: int, nnz: int, n_diagonals: int,
               word: int = 8) -> int:
    if fmt == "dia":
        return (n_diagonals + 2) * n * word
    if fmt == "csr":
        return nnz * (word + 4) + 4 * (n + 1) + 2 * n * word
    raise ValueError(f"no byte count for format {fmt!r}")


def spmv_bound_s(fmt: str, n: int, nnz: int, n_diagonals: int,
                 word: int = 8) -> float:
    """The least seconds one product can take on the card."""
    dtype = "float64" if word == 8 else "float32"
    return max(spmv_bytes(fmt, n, nnz, n_diagonals, word) / HBM_BYTES_PER_S,
               2.0 * nnz / PEAK_FLOPS[dtype])


def fine_products(precond: dict, iters: int) -> int:
    """The fine-operator products one PCG solve of ``iters`` iterations
    needs with ``num_iters`` Jacobi V-cycles per preconditioner apply: one
    product and one apply at the start and in every iteration, and in a
    V-cycle nu_pre + nu_post smoothing products and one residual product
    on the fine level."""
    per_cycle = precond["nu_pre"] + precond["nu_post"] + 1
    return (iters + 1) * (1 + precond["num_iters"] * per_cycle)
