"""resolve_ms_p95: the 95th percentile (linear interpolation between
order statistics) of the wall time of every solve in the window, each from
its call to the synchronise after it returns."""
import numpy as np


def read(run):
    if not run.solves:
        return None
    return 1e3 * float(np.percentile([s["wall_s"] for s in run.solves], 95))
