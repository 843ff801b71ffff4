"""amg_setup.galerkin_s: the host SA build's Galerkin products per solve,
from the program's timer "amg.galerkin" over the window (the tentative
and smoothed prolongators, the filtered matrix, R and R·A·P of each host
level)."""


def read(run):
    t = run.timers.get("amg.galerkin", 0.0)
    if not run.solves or t <= 0.0:
        return None
    return t / len(run.solves)
