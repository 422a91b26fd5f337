from .linop import DIAOperator, LinearOperator
from .generators import (laplacian_1d, laplacian_1d_eigs, laplacian_2d,
                         laplacian_2d_eigs, laplacian_3d, laplacian_3d_eigs)

__all__ = [
    "LinearOperator",
    "DIAOperator",
    "laplacian_1d",
    "laplacian_2d",
    "laplacian_3d",
    "laplacian_1d_eigs",
    "laplacian_2d_eigs",
    "laplacian_3d_eigs",
]
