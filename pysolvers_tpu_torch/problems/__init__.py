from .bratu import Bratu2D, Bratu2DHostOuter
from .fem import fem_poisson_2d_unstructured, graph_laplacian_rgg
from .laplacian import (fd_convection_diffusion_2d, fd_laplacian_1d,
                        fd_laplacian_2d, fd_vector_laplacian_2d)

__all__ = ["fd_laplacian_1d", "fd_laplacian_2d", "fd_convection_diffusion_2d",
           "fd_vector_laplacian_2d", "fem_poisson_2d_unstructured",
           "graph_laplacian_rgg", "Bratu2D", "Bratu2DHostOuter"]
