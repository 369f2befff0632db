"""Process groups and device meshes: counterpart of
``tpu_sparse_lu/parallel/mesh.py`` on ``torch.distributed``.

The JAX package runs its mesh engines SPMD from one controller over a
``jax.sharding.Mesh``. Here every rank is a process of a
``torch.distributed`` process group (NCCL between CUDA devices, gloo on
the CPU) and a mesh is a 1-D :class:`~torch.distributed.device_mesh.DeviceMesh`
over that group. The reference's latent MPI-3 shared-memory window (its
exported ``allocate_shared``) stays what it is in the JAX package: every
rank holds the whole factor.

Start one process per rank, e.g. ``torchrun --nproc-per-node=G prog.py``
(each process then calls :func:`initialize_multihost` with no arguments:
``env://``), or pass the rendezvous yourself (``tcp://host:port`` or
``file:///path``) with the world size and the rank.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

__all__ = [
    "allocate_shared",
    "initialize_multihost",
    "make_global_mesh",
    "make_mesh",
    "mesh_axis",
    "replicate_to_mesh",
]

DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device="cuda",
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> torch.device:
    """Join the process group (``dist.init_process_group``) and return
    this rank's device.

    ``device`` is the rank's device: ``"cuda"`` (the default; the rank's
    card is ``cuda:LOCAL_RANK``, else ``cuda:rank % device_count``) puts
    the group on NCCL, ``"cpu"`` on gloo. ``coordinator_address`` is
    ``host:port`` (taken as ``tcp://host:port``), any ``torch.distributed``
    init URL (``tcp://…``, ``file://…``), or ``None`` for ``env://`` (as
    ``torchrun`` sets it up). ``timeout`` bounds every collective, so a
    lost peer fails instead of hanging.
    """
    device = torch.device(device)
    if coordinator_address is None:
        url = "env://"
    elif "://" in coordinator_address:
        url = coordinator_address
    else:
        url = f"tcp://{coordinator_address}"
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but CUDA is not available")
        if device.index is None:
            rank = (process_id if process_id is not None
                    else int(os.environ.get("RANK", 0)))
            local = os.environ.get("LOCAL_RANK")
            device = torch.device(
                "cuda", int(local) if local is not None
                else rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for {device.type!r}")
    kw = {}
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    dist.init_process_group(backend, init_method=url, timeout=timeout, **kw)
    return device


def _device_type(device_type: Optional[str]) -> str:
    if device_type is not None:
        return device_type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "chunks",
              *, device_type: Optional[str] = None):
    """1-D device mesh over the ranks of the process group.

    ``n_devices`` must be ``None`` or the world size: every rank of a
    torch process group takes part in the mesh's collectives.
    ``device_type`` defaults to ``"cuda"`` under NCCL and ``"cpu"`` under
    gloo (pass ``"cuda"`` for CUDA tensors over gloo).
    """
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_multihost "
                           "first (one process per rank)")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh spans the whole process group: "
                         f"n_devices={n_devices}, world size {world}")
    return init_device_mesh(_device_type(device_type), (world,),
                            mesh_dim_names=(axis_name,))


def make_global_mesh(axis_name: str = "chunks"):
    """1-D mesh over every rank of the process group (equals
    :func:`make_mesh`: a torch process group is always multi-process)."""
    return make_mesh(None, axis_name)


def mesh_axis(mesh, axis: str):
    """``(group, D, d)``: the process group of ``axis``, its size and this
    rank's position on it."""
    return (mesh.get_group(axis), mesh.size(mesh.mesh_dim_names.index(axis)),
            mesh.get_local_rank(axis))


def replicate_to_mesh(tree, mesh):
    """Give every rank rank 0's copy of a tree (tuple, list, dict) of
    tensors: each tensor is broadcast from the first rank of the mesh
    (the counterpart of ``jax.make_array_from_callback`` onto a replicated
    sharding: every rank then maps the same "window"). Tensors must lie on
    the mesh's device type with the same shape on every rank; a new tree
    is returned."""
    group = mesh.get_group(mesh.mesh_dim_names[0])
    src = dist.get_global_rank(group, 0)

    def put(x):
        if isinstance(x, (tuple, list)):
            return type(x)(put(v) for v in x)
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        t = x.detach().clone().contiguous()
        dist.broadcast(t, src=src, group=group)
        return t

    return put(tree)


def allocate_shared(shape: Sequence[int], dtype=torch.float32, *,
                    mesh=None, spec=None, device="cuda"):
    """A zero tensor shared across the mesh: the counterpart of the
    reference's exported ``allocate_shared`` (an MPI-3 shared-memory
    window) and of the JAX package's ``NamedSharding`` array.

    With a ``mesh`` it is a ``DTensor`` over the mesh with the placements
    ``spec`` (default ``[Replicate()]``: every rank holds the whole array,
    like ranks mapping one window; ``[Shard(d)]`` splits dimension ``d``).
    Without one it is a plain tensor on ``device``.
    """
    if mesh is None:
        return torch.zeros(tuple(shape), dtype=dtype, device=device)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor import zeros as dzeros

    placements = list(spec) if spec is not None else [Replicate()]
    return dzeros(*shape, dtype=dtype, device_mesh=mesh,
                  placements=placements)
