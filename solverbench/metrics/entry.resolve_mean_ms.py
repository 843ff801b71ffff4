"""entry.resolve_mean_ms: the window's wall time over the frozen solves
completed in it, as ``resolve_ms`` reads it, per layer: in the banded
re-solve cell it swings with the host's speed from run to run by more than
the largest bound allows, so there it is read, not bounded."""
from solverbench.lib import spec as S


def read(run):
    return S.metric_reader("resolve_ms")(run)
