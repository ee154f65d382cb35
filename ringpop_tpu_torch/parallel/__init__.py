"""The in-process shard mesh (counterpart of ``ringpop_tpu/parallel``).

``comm`` holds the collectives and the lockstep loop; ``mesh`` the mesh
itself, the capped all-to-all row routing, the exchange plane and
``ShardedStorm``.  Nothing is imported here, so the engine may import
``comm``'s pieces without pulling in ``ShardedStorm``.
"""
