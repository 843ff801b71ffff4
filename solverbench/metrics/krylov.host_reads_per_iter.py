"""krylov.host_reads_per_iter: the program's device-to-host reads over the
window (its counter "host_reads": every read of the Krylov solvers and of
the status they return) per CG iteration of the window's solves.  PCG
reads its stop reason once per iteration and once before the first, and
the status reads the residual and its history: (iters + 3) / iters.  None
where the program keeps no such counter."""


def read(run):
    from pysolvers_tpu_torch.utils.timing import Timer
    reads = Timer._counts.get("host_reads", 0)
    iters = sum(s["iters"] for s in run.solves)
    if reads <= 0 or iters <= 0:
        return None
    return reads / iters
