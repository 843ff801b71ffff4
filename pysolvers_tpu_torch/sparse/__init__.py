from .host import HostCSR
from .device import EllMatrix, DiaMatrix

__all__ = ["HostCSR", "EllMatrix", "DiaMatrix"]
