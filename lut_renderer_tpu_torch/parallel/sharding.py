"""The frame batch split across devices.

Counterpart of lut_renderer_tpu/parallel/sharding.py. The JAX package
shards the batch axis over a jax.sharding.Mesh with shard_map; here the
"mesh" is a list of devices, and the split is explicit: the batch axis is
cut into one contiguous chunk per device, each chunk renders on its
device's own stream with that device's copy of the LUT (one
``lut_operands_for`` per device, through ``make_render_fn``), and the
outputs are concatenated in order on the first device. Frames are
independent, so there is no collective, as in the JAX package.

A list may repeat a device (``["cpu", "cpu"]``, ``["cuda:0", "cuda:0"]``):
its chunks then run on separate streams of one card, which is how the
split is tested on the CPU and on a one-card machine. Every frame renders
as it would in the whole batch (ops.resample works frame by frame), so
the split is bit-equal to the unsharded function.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.render import RenderConfig, make_render_fn


def default_mesh(devices: Optional[Sequence[DeviceLike]] = None
                 ) -> List[torch.device]:
    """`devices` resolved, or every visible CUDA device. Raises where torch
    sees no CUDA device and none were named; there is no CPU fallback."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("no CUDA device is visible to split the batch "
                               "over")
        devices = [f"cuda:{i}" for i in range(count)]
    return [resolve_device(d) for d in devices]


def shard_batch_size(devices: Sequence[DeviceLike],
                     per_device_frames: int = 1) -> int:
    return len(devices) * per_device_frames


def put_sharded(devices: Sequence[DeviceLike], *arrays):
    """Split each array (numpy or tensor) along the frame axis into one
    contiguous chunk per device, each copied to its device: a list of
    chunks per array. A batch that does not divide leaves the last chunks
    one frame shorter."""
    devs = [resolve_device(d) for d in devices]
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a)) \
            if isinstance(a, np.ndarray) else a
        out.append([c.to(d, non_blocking=True)
                    for c, d in zip(torch.tensor_split(t, len(devs)), devs)])
    return tuple(out)


def make_sharded_render_fn(lut, cfg: RenderConfig,
                           devices: Sequence[DeviceLike], chain: int = 1):
    """A render function ``fn(y, u, v) -> (yq, uq, vq)`` that splits the
    batch axis over `devices`: inputs anywhere (the host or a device),
    outputs on ``devices[0]``, in frame order.

    chain > 1 renders each chunk that many times on its device, the
    output feeding the next input, as the JAX package's lax.scan does for
    its device-resident measurements; it needs a config whose output can
    feed its input (same depth and subsampling in and out)."""
    if chain > 1 and (cfg.in_depth != cfg.out_depth
                      or cfg.in_subsampling != cfg.out_subsampling):
        raise ValueError("chain>1 needs output geometry == input geometry")
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("no devices to split the batch over")
    fns = [make_render_fn(lut, cfg, d) for d in devs]
    streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
               for d in devs]
    home = devs[0]

    def render_chunk(fn, planes):
        for _ in range(chain):
            planes = fn(*planes)
        return planes

    def call(y, u, v):
        # a batch shorter than the device list leaves some devices idle
        parts = [(fn, dev, stream, planes) for fn, dev, stream, planes
                 in zip(fns, devs, streams, zip(*put_sharded(devs, y, u, v)))
                 if planes[0].shape[0]]
        if home.type != "cuda":
            outs = [render_chunk(fn, planes) for fn, _, _, planes in parts]
            return tuple(torch.cat([o[k].to(home) for o in outs])
                         for k in range(3))
        # each chunk's stream waits for the caller's work on its inputs and
        # for their copy (on the destination's current stream from the
        # host); the caller's stream waits for every chunk before the concat
        caller = torch.cuda.current_stream(home)
        outs = []
        for fn, dev, stream, planes in parts:
            stream.wait_stream(caller)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                for p in planes:
                    p.record_stream(stream)
                done = render_chunk(fn, planes)
                # a copy runs on the source's current stream: this one
                outs.append([o.to(home, non_blocking=True) for o in done])
        for _, _, stream, _ in parts:
            caller.wait_stream(stream)
        for o in outs:
            for t in o:
                t.record_stream(caller)
        return tuple(torch.cat([o[k] for o in outs]) for k in range(3))

    return call
