"""Data and sequence parallelism over ``torch.distributed`` (the JAX
package's ``parallel/``): the mesh, the sharding rules, the collectives."""
from .mesh import make_mesh

__all__ = ["make_mesh"]
