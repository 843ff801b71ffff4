"""bmg.device_ms_per_iter: the device time of the traced window (the union
of its kernels, copies and sets) over the CG iterations of the solves
traced, in milliseconds: what one PCG + block-MG iteration costs the card.
The reading of ``gmg.device_ms_per_iter``, for the block lane's cell."""
from solverbench.lib import spec as S


def read(run):
    return S.plugin("metrics", "gmg.device_ms_per_iter").read(run)
