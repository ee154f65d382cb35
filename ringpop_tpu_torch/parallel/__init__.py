"""The in-process shard mesh (counterpart of ``ringpop_tpu/parallel``).

``comm`` holds the collectives and the lockstep loop; ``mesh`` the mesh
itself, ``ShardedSim`` (the full engine), the capped all-to-all row
routing, the exchange plane and ``ShardedStorm`` (the scalable engine).
The engines import nothing from here, so their shard bodies stay free of
the drivers.
"""

from ringpop_tpu_torch.parallel.comm import MeshComm, lockstep
from ringpop_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedSim,
    ShardedStorm,
    make_exchange_plane,
    make_mesh,
    make_mesh_2d,
)

__all__ = [
    "Mesh",
    "MeshComm",
    "ShardedSim",
    "ShardedStorm",
    "lockstep",
    "make_exchange_plane",
    "make_mesh",
    "make_mesh_2d",
]
