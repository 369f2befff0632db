"""The control of a banded deployment: the banded reference computed in
TF32.

The block Thomas algorithm of ``banded_f64``, in float32 with every
product's operands rounded to TF32 (``tf32_control``), each diagonal
block factored by ``tf32_control``'s blocked LU with TF32 products and no
pivoting (the deployments it serves are block diagonally dominant).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from h100_bench.reference import banded_f64, tf32_control


def _lu(M: torch.Tensor):
    LU = tf32_control.lu_tf32(M.clone())
    return lambda R: tf32_control.substitute(LU, R.clone())


def solve(A: sp.csc_matrix, B: np.ndarray, device) -> np.ndarray:
    """``A⁻¹ B`` as a TF32 computation would give it, ``B`` (n, m)."""
    return banded_f64.thomas(A, B, device, torch.float32, _lu,
                             tf32_control.mm)
