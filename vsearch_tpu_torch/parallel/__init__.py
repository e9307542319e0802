"""Device meshes, collectives and mesh-sharded search (counterpart of
``vsearch_tpu/parallel``)."""
from .mesh import Mesh, make_mesh, shard_batch

__all__ = ["Mesh", "make_mesh", "shard_batch"]
