"""kernels.block_spmv_roofline: the block operator's products against
their bound.

The traced solves needed ``roofline_bdia.pcg_products`` operator products
(from their iterations); each moves at least the bytes of
``roofline_bdia.bdia_spmv_bytes`` for the configuration's block size
(``operator.b``) and its count of block diagonals (``block_offsets``, a
count from the operator's definition, not a pass over its entries).  The
device time of those products is that of the longest launches, as many as
there are products, of the kernels that ``kernels/*.json`` lists for the
"bdia" format (K4's ``bdia_spmv_kernel``).  The share is the bound time
over that device time, in %; nothing is read where the configuration has
no block size or the trace holds fewer such launches than products."""
from solverbench.lib import roofline_bdia


def read(run):
    if run.trace is None or "block_offsets" not in run.cfg:
        return None
    names = [k["contains"] for k in run.kernels if k["format"] == "bdia"]
    durs = sorted((d for n, d in zip(run.trace.kernel_names,
                                     run.trace.kernel_s)
                   if any(s in n for s in names)), reverse=True)
    products = sum(roofline_bdia.pcg_products(s["iters"])
                   for s in run.solves if s["traced"])
    if products <= 0 or len(durs) < products:
        return None
    b = run.cfg["operator"]["b"]
    bound = roofline_bdia.bdia_spmv_bound_s(
        run.A.n // b, b, run.cfg["block_offsets"],
        word=8 if run.cfg["dtype"] == "float64" else 4)
    return 100.0 * products * bound / sum(durs[:products])
