"""The x-split sharded uniform step and the split forest on a slab mesh
(``mesh``, ``forest_mesh``), their explicit halo exchange and split
stencils (``shard_halo``), and the multi-process bring-up on
``torch.distributed`` (``launch``)."""

from .launch import global_mesh, init_distributed  # noqa: F401
