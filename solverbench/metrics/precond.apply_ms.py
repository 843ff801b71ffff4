"""precond.apply_ms: host milliseconds per AMG preconditioner apply
(``num_iters`` V-cycles) in the traced solves, from the program's span
"amg.apply" (its total over its calls, recorded while the profiler
runs)."""


def read(run):
    from pysolvers_tpu_torch.utils.timing import Timer
    total = run.timers.get("amg.apply", 0.0)
    calls = Timer._counts.get("amg.apply", 0)
    if total <= 0.0 or calls <= 0:
        return None
    return 1e3 * total / calls
