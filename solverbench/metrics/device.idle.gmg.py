"""device.idle.gmg: the share of the traced window of frozen PCG + GMG
re-solves in which no kernel, copy or set ran on the card, in %."""
from solverbench.lib.trace import idle_percent


def read(run):
    return idle_percent(run)
