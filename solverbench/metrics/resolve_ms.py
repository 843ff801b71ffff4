"""resolve_ms: the window's wall time over the solves completed in it,
each against the frozen operator and preconditioner."""


def read(run):
    if not run.solves:
        return None
    return 1e3 * run.window_s / len(run.solves)
