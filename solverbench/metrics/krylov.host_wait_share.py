"""krylov.host_wait_share: the share of the traced solves' CG calls that
the host spent waiting on its reads of the card, in %: the program's
spans "krylov.host_read" over "krylov.cg" (host clock, recorded while the
profiler runs).  The status's two reads after each call fall outside
"krylov.cg" and are counted too (tens of microseconds a solve)."""


def read(run):
    cg = run.timers.get("krylov.cg", 0.0)
    wait = run.timers.get("krylov.host_read", 0.0)
    if cg <= 0.0 or wait <= 0.0:
        return None
    return 100.0 * wait / cg
