"""kernels.gmg_fine_roofline: the GMG fine level's products against their
bound, whatever kernel computes them.

The traced solves needed ``roofline.fine_products`` fine-level products
(from their iterations and the configuration's V-cycle); each moves at
least the DIA bytes of ``roofline.spmv_bytes`` with the configuration's
``fine_diagonals`` (a count from the operator's definition, not a pass
over its entries).  The device time of those products is that of the
longest launches, as many as there are products, of the kernels that
``kernels/*.json`` lists for the "dia" format: K1's ``dia_spmv_kernel``
and K6's ``grid_dia_spmv_kernel``, which holds that name, so the fine
level counts on either kernel.  The share is the bound time over that
device time, in %; nothing is read where the trace holds fewer such
launches than products."""
from solverbench.lib import roofline


def read(run):
    if run.trace is None or "fine_diagonals" not in run.cfg:
        return None
    names = [k["contains"] for k in run.kernels if k["format"] == "dia"]
    durs = sorted((d for n, d in zip(run.trace.kernel_names,
                                     run.trace.kernel_s)
                   if any(s in n for s in names)), reverse=True)
    products = sum(roofline.fine_products(run.cfg["solver"]["precond"],
                                          s["iters"])
                   for s in run.solves if s["traced"])
    if products <= 0 or len(durs) < products:
        return None
    bound = roofline.spmv_bound_s(
        "dia", run.A.n, run.A.nnz, run.cfg["fine_diagonals"],
        word=8 if run.cfg["dtype"] == "float64" else 4)
    return 100.0 * products * bound / sum(durs[:products])
