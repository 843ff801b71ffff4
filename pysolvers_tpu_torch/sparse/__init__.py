from .host import HostCSR
from .device import EllMatrix, DiaMatrix
from .bws import BwsMatrix

__all__ = ["HostCSR", "EllMatrix", "DiaMatrix", "BwsMatrix"]
