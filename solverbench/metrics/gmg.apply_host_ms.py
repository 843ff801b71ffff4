"""gmg.apply_host_ms: host milliseconds per GMG preconditioner apply
(``num_iters`` grid V-cycles) in the traced solves, from the program's span
"gmg.apply" (its total over its calls, recorded while the profiler runs):
the host's cost to launch one apply.  Nothing is read where the program
has no such span."""


def read(run):
    from pysolvers_tpu_torch.utils.timing import Timer
    total = run.timers.get("gmg.apply", 0.0)
    calls = Timer._counts.get("gmg.apply", 0)
    if total <= 0.0 or calls <= 0:
        return None
    return 1e3 * total / calls
