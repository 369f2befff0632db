"""What the one-launch kernels' task lists share: the hazard rule that
orders their tasks (``fused_ldiv.build_ldiv_schedule``,
``elim_fused.build_elim_tasks``)."""

from __future__ import annotations

__all__ = ["hazard_deps"]


def hazard_deps(access, n_blocks: int):
    """Per task, the earlier tasks it must wait for, from each task's
    ``(reads, writes)`` blocks in order (ids below ``n_blocks``): the last
    writer of every block it reads or writes (RAW, WAW) and every reader
    of a block it writes since that block's last write (WAR)."""
    last = [-1] * n_blocks
    readers = [[] for _ in range(n_blocks)]
    out = []
    for t, (reads, writes) in enumerate(access):
        need = {last[c] for c in list(reads) + list(writes) if last[c] >= 0}
        for c in writes:
            need.update(readers[c])
        out.append(sorted(need))
        for c in reads:
            readers[c].append(t)
        for c in writes:
            last[c] = t
            readers[c] = []
    return out
