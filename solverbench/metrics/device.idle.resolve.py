"""device.idle.resolve: the share of the traced window of frozen re-solves
in which no kernel, copy or set ran on the card."""
from solverbench.lib.trace import idle_percent


def read(run):
    return idle_percent(run)
