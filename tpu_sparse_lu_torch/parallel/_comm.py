"""The collectives the mesh engines issue, counted per solve.

Each engine's ``solve`` owns a :class:`Collectives`; its ``counts`` hold
what the last call issued (``all_reduce`` calls, ``send_recv`` batches),
the figure ``chip_smoke.py`` prints beside each engine's time.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

__all__ = ["Collectives", "check_device"]


def check_device(F, group) -> None:
    """Refuse a solver whose device the group's backend cannot serve: no
    engine carries on on the CPU when the group is NCCL."""
    backend = dist.get_backend(group)
    if backend == "nccl" and F.device.type != "cuda":
        raise ValueError(f"an NCCL group needs a solver on a CUDA device, "
                         f"this one is on {F.device}")


class Collectives:
    """The collectives of one engine on one process group."""

    def __init__(self, group, D: int, d: int):
        self.group, self.D, self.d = group, D, d
        self.counts: Dict[str, int] = {}

    def reset(self) -> None:
        self.counts = {"all_reduce": 0, "send_recv": 0}

    def all_reduce(self, t: torch.Tensor) -> None:
        dist.all_reduce(t, group=self.group)
        self.counts["all_reduce"] += 1

    def peer(self, j: int) -> int:
        """Global rank of position ``j`` on the mesh axis."""
        return dist.get_global_rank(self.group, j)

    def neighbours(self, fwd: Optional[torch.Tensor],
                   bwd: Optional[torch.Tensor],
                   recv_fwd: Optional[torch.Tensor],
                   recv_bwd: Optional[torch.Tensor]) -> None:
        """One batch of point-to-point transfers with the neighbours, both
        ends posted together: send ``fwd`` to the next position and
        ``bwd`` to the previous one, receive ``recv_fwd`` from the
        previous and ``recv_bwd`` from the next; ``None`` where there is
        nothing to move, and a side with no neighbour is skipped. An
        empty batch posts nothing."""
        d, D = self.d, self.D
        ops = []
        for t, j, op in ((fwd, d + 1, dist.isend), (bwd, d - 1, dist.isend),
                         (recv_fwd, d - 1, dist.irecv),
                         (recv_bwd, d + 1, dist.irecv)):
            if t is not None and 0 <= j < D:
                ops.append(dist.P2POp(op, t, self.peer(j), self.group))
        if not ops:
            return
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        self.counts["send_recv"] += 1
