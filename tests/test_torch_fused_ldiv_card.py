"""``ldiv_fused`` on a CUDA card at every strip width the kernel is built
for: the same bits at every width and grid, equal to the parent's width
(16 columns at R > 4) and to the 32-launch route (``perm_gather``, the L
and U waves, ``perm_gather``).

Each strip width only groups columns: every output element gets the same
entry order, the same 8-warp split of k and the same warp-order sum. This
file imports no JAX, so it runs on a card's machine without it:

    python3 -m pytest --noconftest tests/test_torch_fused_ldiv_card.py -q

(``tests/conftest.py`` loads JAX). Without a card every test skips.
"""

import numpy as np
import pytest
import torch

import tpu_sparse_lu_torch as tlu
from tpu_sparse_lu_torch.models import block_banded, poisson_2d
from tpu_sparse_lu_torch.ops import fused_ldiv as FL
from tpu_sparse_lu_torch.solve import blocked_tri_solve

# the benchmark's deep, narrow plan at full size, and a small Poisson plan
# with wide levels
CASES = {
    "banded_120x30": (lambda: block_banded(np.random.default_rng(0), 120, 30),
                      dict(chunk_size=128, ordering="colamd")),
    "poisson_40": (lambda: poisson_2d(40, 40),
                   dict(chunk_size=32, ordering="nd")),
}
TILES = {"float32": ("float32", "float32"), "float64": ("float64", "float32"),
         "bfloat16": ("float32", "bfloat16")}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _route32(F, b):
    R = b.shape[1]
    xw = FL.perm_gather(b, F._pidx, F._rs).view(F.plan.lplan.K + 1,
                                                F.plan.cs, R)
    blocked_tri_solve(F.ldata, xw, stream=True)
    blocked_tri_solve(F.udata, xw, stream=True)
    return FL.perm_gather(xw.view(-1, R), F._qidx)


@pytest.mark.parametrize("tiles", sorted(TILES))
@pytest.mark.parametrize("R", [8, 16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_every_strip_gives_the_same_bits(card, case, R, tiles):
    make, cfg = CASES[case]
    dtype, stream = TILES[tiles]
    F = tlu.ParallelSparseLU(make(), config=tlu.SolverConfig(
        dtype=dtype, stream_dtype=stream, **cfg), device="cuda")
    S, L, U = F._ldiv_sched, F.ldata, F.udata
    b = torch.as_tensor(np.random.default_rng(17).standard_normal((F.n, R)),
                        dtype=F.dtype, device="cuda")
    if tiles == "bfloat16":
        wrapper = FL.fused_ldiv_bf16
        run = lambda **kw: wrapper(b, S, L.tiles_bf16, U.tiles_bf16, F._rs,
                                   **kw)
    else:
        wrapper = FL.fused_ldiv
        run = lambda **kw: wrapper(b, S, L.tiles_t, U.tiles_t, F._rs, **kw)
    want = run(strip=16)
    assert torch.equal(want, _route32(F, b))
    narrow = wrapper.NARROW_LAUNCHES
    assert torch.equal(run(), want)
    assert torch.equal(F._direct_solve(b), want)
    rb = FL.launch_strip(f"ldiv_fused_{FL._KERNEL_DTYPES[F.dtype]}"
                         if tiles != "bfloat16" else "ldiv_fused_bf16",
                         S, R, b.device)
    assert wrapper.NARROW_LAUNCHES - narrow == 2 * (rb < min(R, 16))
    if case == "banded_120x30":  # a chain: the rule goes narrow
        assert rb < R
    for strip in FL.TASK_US:
        for grid in (None, 1, 7):
            assert torch.equal(run(strip=strip, grid=grid), want), (strip,
                                                                    grid)
    torch.cuda.synchronize()
