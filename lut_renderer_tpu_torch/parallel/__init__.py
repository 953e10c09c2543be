"""parallel: the frame batch split across devices (counterpart of
lut_renderer_tpu/parallel)."""

from .sharding import default_mesh, make_sharded_render_fn, shard_batch_size

__all__ = ["default_mesh", "make_sharded_render_fn", "shard_batch_size"]
