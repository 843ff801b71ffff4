"""krylov.iters: the mean CG iterations per solve over the window, from
each solve's SolveStatus.iters."""


def read(run):
    if not run.solves:
        return None
    return sum(s["iters"] for s in run.solves) / len(run.solves)
