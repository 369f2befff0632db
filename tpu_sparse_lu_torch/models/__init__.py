from .matrices import (
    block_banded,
    dense_random,
    fe_block_matrix,
    laplacian_1d,
    poisson_2d,
    random_sparse,
)

__all__ = [
    "block_banded",
    "dense_random",
    "fe_block_matrix",
    "laplacian_1d",
    "poisson_2d",
    "random_sparse",
]
