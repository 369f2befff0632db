"""The mesh engines over ``torch.distributed``: counterpart of
``tpu_sparse_lu/parallel``. One process per rank; see :mod:`.mesh`."""

from .mesh import allocate_shared, make_mesh

__all__ = ["allocate_shared", "make_mesh"]
