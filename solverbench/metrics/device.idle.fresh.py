"""device.idle.fresh: the share of the traced window of fresh solves
(each building its hierarchy) in which no kernel, copy or set ran on the
card."""
from solverbench.lib.trace import idle_percent


def read(run):
    return idle_percent(run)
