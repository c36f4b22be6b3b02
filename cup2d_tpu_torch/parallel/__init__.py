"""The x-split sharded uniform step on a single-controller slab mesh
(``mesh``) and its explicit halo exchange and split stencils
(``shard_halo``)."""
