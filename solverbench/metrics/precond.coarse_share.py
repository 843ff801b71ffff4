"""precond.coarse_share: the share of the V-cycle's host time spent below
the fine level, in %: the program's span "amg.level.<K-1>" over
"amg.level.<K>" in the traced solves, K the largest level index recorded
(the fine level; 0 is the coarsest, each level's span holds its coarser
levels)."""

PREFIX = "amg.level."


def read(run):
    levels = {int(k[len(PREFIX):]): v for k, v in run.timers.items()
              if k.startswith(PREFIX) and k[len(PREFIX):].isdigit()}
    if not levels:
        return None
    top = max(levels)
    if top < 1 or levels[top] <= 0.0 or top - 1 not in levels:
        return None
    return 100.0 * levels[top - 1] / levels[top]
