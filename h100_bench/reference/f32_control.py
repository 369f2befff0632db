"""The control of a float64 deployment: the reference solve computed in
float32.

The deployment states float64 answers, so the nearest precision below it
is float32, the precision of the program's own direct solve: a dense
float32 LU with partial pivoting (``torch.linalg.solve``), with TF32 off
so that no product rounds below float32. Its answer is returned as
float64.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from h100_bench.reference.dense_f64 import dense


def solve(A: sp.csc_matrix, B: np.ndarray, device) -> np.ndarray:
    """``A⁻¹ B`` in float32, ``B`` (n, m), as a float64 array."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        M = dense(A, device).to(torch.float32)
        X = torch.linalg.solve(M, torch.as_tensor(
            B, dtype=torch.float32, device=device))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return X.double().cpu().numpy()
