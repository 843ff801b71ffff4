"""device.idle.block: the share of the traced window of frozen PCG +
block-MG re-solves on the block-DIA lane in which no kernel, copy or set
ran on the card, in %."""
from solverbench.lib.trace import idle_percent


def read(run):
    return idle_percent(run)
