from .host import HostCSR
from .device import EllMatrix, DiaMatrix
from .bws import BwsMatrix
from .bdia import BdiaMatrix, detect_block_size

__all__ = ["HostCSR", "EllMatrix", "DiaMatrix", "BwsMatrix", "BdiaMatrix",
           "detect_block_size"]
