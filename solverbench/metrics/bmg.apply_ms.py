"""bmg.apply_ms: host milliseconds per block-MG preconditioner apply (one
V-cycle per field over the b fields) in the traced solves, from the
program's span "bmg.apply" (its total over its calls, recorded while the
profiler runs): the host's cost to issue one apply, on one card one CUDA
graph launch where the program replays the apply as a graph.  Nothing is
read where the program has no such span."""


def read(run):
    from pysolvers_tpu_torch.utils.timing import Timer
    total = run.timers.get("bmg.apply", 0.0)
    calls = Timer._counts.get("bmg.apply", 0)
    if total <= 0.0 or calls <= 0:
        return None
    return 1e3 * total / calls
