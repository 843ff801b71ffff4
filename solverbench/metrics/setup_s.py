"""setup_s: seconds from the start of the process to the first timed
solve: imports, the operator, the solver, the warm-up solve (the
preconditioner's build and, in a fresh checkout, the kernels' build)."""


def read(run):
    return run.setup_s
