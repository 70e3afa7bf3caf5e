"""Device-mesh / sharding helpers for multi-chip scale-out."""

from bauklank.parallel.mesh import stream_mesh, shard_streams, sharded_step

__all__ = ["stream_mesh", "shard_streams", "sharded_step"]
