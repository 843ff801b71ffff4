"""fresh_s: the window's wall time over the solves completed in it, each
on a new operator whose preconditioner the solver builds anew."""


def read(run):
    if not run.solves:
        return None
    return run.window_s / len(run.solves)
