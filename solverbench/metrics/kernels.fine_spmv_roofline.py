"""kernels.fine_spmv_roofline: the fine operator's products against their
bound, whatever kernel computes them.

The traced solves needed ``roofline.fine_products`` fine-level products
(from their iterations and the configuration's V-cycle); each moves at
least the bytes of ``roofline.spmv_bytes`` for the configuration's
``fine_format``.  The device time of those products is that of the
longest launches, as many as there are products, of the kernels that
``kernels/*.json`` lists for that format: the fine operator is the
largest operator those kernels multiply by.  The share is the bound time
over that device time, in %; nothing is read where the trace holds fewer
such launches than products."""
from solverbench.lib import roofline


def read(run):
    if run.trace is None:
        return None
    fmt = run.cfg["fine_format"]
    names = [k["contains"] for k in run.kernels if k["format"] == fmt]
    durs = sorted((d for n, d in zip(run.trace.kernel_names,
                                     run.trace.kernel_s)
                   if any(s in n for s in names)), reverse=True)
    products = sum(roofline.fine_products(run.cfg["solver"]["precond"],
                                          s["iters"])
                   for s in run.solves if s["traced"])
    if products <= 0 or len(durs) < products:
        return None
    A = run.A
    bound = roofline.spmv_bound_s(
        fmt, A.n, A.nnz, A.n_diagonals() if fmt == "dia" else 0,
        word=8 if run.cfg["dtype"] == "float64" else 4)
    return 100.0 * products * bound / sum(durs[:products])
