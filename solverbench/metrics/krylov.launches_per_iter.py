"""krylov.launches_per_iter: the device kernels the profiler recorded in
the traced window over the CG iterations of the solves traced."""


def read(run):
    if run.trace is None:
        return None
    iters = sum(s["iters"] for s in run.solves if s["traced"])
    if iters <= 0 or len(run.trace.kernel_names) == 0:
        return None
    return len(run.trace.kernel_names) / iters
