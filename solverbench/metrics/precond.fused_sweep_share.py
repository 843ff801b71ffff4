"""precond.fused_sweep_share: the share of the window's weighted-Jacobi
sweeps that one launch of K1 or K6 with its epilogue computed, in %: the
program's counters "smooth.fused_sweeps" over "smooth.jacobi_sweeps"
(always on; a CUDA graph's replay counts nothing, so in a graphed apply
they count its eager call and its capture).  None where no sweep is
counted, as in a program without them, and where the traced window ran
nothing on a card (the CPU, where no kernel can serve a sweep)."""


def read(run):
    from pysolvers_tpu_torch.utils.timing import Timer
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    sweeps = Timer._counts.get("smooth.jacobi_sweeps", 0)
    if sweeps <= 0:
        return None
    return 100.0 * Timer._counts.get("smooth.fused_sweeps", 0) / sweeps
