"""gmg.device_ms_per_iter: the device time of the traced window (the union
of its kernels, copies and sets) over the CG iterations of the solves
traced, in milliseconds: what one PCG + GMG iteration costs the card."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    iters = sum(s["iters"] for s in run.solves if s["traced"])
    if iters <= 0:
        return None
    return 1e3 * run.trace.busy_s / iters
