"""A deep plan for ``ldiv_fused``'s runs, shared by the CPU and card tests.

At chunk_size 16 the block-banded matrix of 300 blocks of 8 rows solves
through two runs of ~300 one-tile tasks (the L levels, then the U levels),
so each run's ready flags go out in several batches of ``RUN_BATCH``
tasks, and each later batch waits on flags outside the run.
``padded_waits`` adds redundant dependencies, so that a batch waits on
more flags outside its run than warp 0 reads ahead (``READ_AHEAD``).
"""

import dataclasses
import re
from pathlib import Path

import numpy as np

from tpu_sparse_lu_torch.models import block_banded

_SRC = (Path(__file__).resolve().parent.parent / "tpu_sparse_lu_torch"
        / "csrc" / "ldiv_fused.cu").read_text()
# a run's tasks per fence (kRunBatch)
RUN_BATCH = int(re.search(r"constexpr int kRunBatch = (\d+);", _SRC)[1])
# the flags outside a run that warp 0 reads ahead for a batch: four a lane
READ_AHEAD = 4 * 32

DEEP = (lambda: block_banded(np.random.default_rng(0), 300, 8),
        dict(chunk_size=16, ordering="colamd"))


def batch_waits(S):
    """Per run, the flags outside it that each batch after the first waits
    on."""
    out = []
    for t0, t1 in S.runs:
        n = t1 - t0 + 1
        out.append([int(S.wait_ptr[t0 + min(n, a + RUN_BATCH)]
                         - S.wait_ptr[t0 + a])
                    for a in range(RUN_BATCH, n, RUN_BATCH)])
    return out


def padded_waits(S, k: int):
    """``S`` with every task of a run also depending on the tasks ``0..k-1``
    (perm-in tasks, before every run): the same order of work, more flags
    to poll."""
    deps = [S.dep[S.dep_ptr[t]:S.dep_ptr[t + 1]].tolist()
            for t in range(S.n_tasks)]
    for t0, t1 in S.runs:
        assert k <= t0
        for t in range(t0, t1 + 1):
            deps[t] = sorted(set(deps[t]) | set(range(k)))
    dep_ptr = np.concatenate([[0], np.cumsum([len(d) for d in deps])])
    return dataclasses.replace(
        S, dep_ptr=dep_ptr.astype(np.int32),
        dep=np.asarray([x for d in deps for x in d], dtype=np.int32))
