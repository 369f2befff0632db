"""Batched inverses of the diagonal triangular tiles.

Counterpart of ``tpu_sparse_lu.solve.tile_inverses``. The JAX package
inverts by blocked recursion and a nilpotent series because sequential
substitution is hostile to the TPU's matrix unit; here a batched
triangular solve against the identity does it. It runs once per
(re)factorization, outside any kernel.
"""

from __future__ import annotations

import torch

__all__ = ["tri_inverse"]


def tri_inverse(tiles: torch.Tensor, *, lower: bool) -> torch.Tensor:
    """Inverses of the non-unit triangular tiles ``(B, cs, cs)``."""
    eye = torch.eye(tiles.shape[-1], dtype=tiles.dtype, device=tiles.device)
    return torch.linalg.solve_triangular(
        tiles, eye.expand_as(tiles), upper=not lower
    )
