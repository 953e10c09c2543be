"""parallel: the frame batch split across devices (counterpart of
lut_renderer_tpu/parallel)."""

from .sharding import (SplitStats, default_mesh, make_sharded_render_fn,
                       peer_bytes, shard_batch_size)

__all__ = ["SplitStats", "default_mesh", "make_sharded_render_fn",
           "peer_bytes", "shard_batch_size"]
