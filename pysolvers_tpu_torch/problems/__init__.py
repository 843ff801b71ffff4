from .laplacian import fd_laplacian_1d, fd_laplacian_2d

__all__ = ["fd_laplacian_1d", "fd_laplacian_2d"]
