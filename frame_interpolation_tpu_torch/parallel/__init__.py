"""Sharded serving of the port: the device mesh, shards in threads, and the
patch-, tree- and row-sharded interpolators (JAX package: parallel/)."""

from .inference import (ShardedInterpolator, ShardedVideoInterpolator,
                        SpatialShardedInterpolator)
from .mesh import (DATA_AXIS, Mesh, create_mesh, replicate, shard_batch,
                   visible_devices)
from .shard_map import Collective, ShardAborted, run_shards

__all__ = [
    'Collective', 'DATA_AXIS', 'Mesh', 'ShardAborted', 'ShardedInterpolator',
    'ShardedVideoInterpolator', 'SpatialShardedInterpolator', 'create_mesh',
    'replicate', 'run_shards', 'shard_batch', 'visible_devices',
]
