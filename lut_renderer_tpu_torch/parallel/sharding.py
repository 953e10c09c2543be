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

Spans (``spans.span``): each call opens ``sharding.call`` (attributes
``cards``, ``frames``, and ``peer_bytes``: what it copies from one card to
another, in and out, by ``peer_bytes``), with the children
``sharding.put`` (the chunks enqueued to their devices), one
``sharding.chunk`` a device that gets frames (attributes ``card``, its
place in the device list, and ``frames``: its render and its copy home
enqueued) and ``sharding.gather`` (the streams' waits and the concat on
the first device). The render function's ``stats``, a ``SplitStats``,
sums the calls.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from math import prod
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.render import RenderConfig, make_render_fn
from ..spans import span


@dataclass
class SplitStats:
    """A split render function's counters: its calls, the frames each
    device of its list rendered, and the bytes copied between cards."""

    calls: int = 0
    frames: List[int] = field(default_factory=list)
    peer_bytes: int = 0

    def summary(self) -> str:
        return (f"split over {len(self.frames)} devices: {self.calls} calls, "
                f"frames {'/'.join(map(str, self.frames))}, "
                f"{self.peer_bytes / 1e6:.1f} MB between cards")


def chunk_frames(batch: int, parts: int) -> List[int]:
    """The frames of each chunk that ``torch.tensor_split`` cuts a batch of
    `batch` frames into `parts` of: the first ``batch % parts`` one frame
    longer."""
    return [(batch + parts - 1 - i) // parts for i in range(parts)]


def peer_bytes(shapes: Sequence[Sequence[int]], dtype: torch.dtype,
               source: DeviceLike, devices: Sequence[DeviceLike]) -> int:
    """The bytes that moving planes of `shapes` (frame axis first, one
    batch) and `dtype` between `source` and `devices`, one chunk a device
    as ``put_sharded`` cuts them, copies from one card to another: the
    chunks on a card other than a `source` card. A chunk on the source's
    own device, and a copy from or to the host, count 0. The split's
    inputs and its outputs' gather home are each one such move."""
    src = torch.device(source)
    if src.type != "cuda":
        return 0
    per_frame = sum(prod(s[1:]) for s in shapes) * dtype.itemsize
    frames = chunk_frames(shapes[0][0], len(devices))
    return sum(n * per_frame
               for n, d in zip(frames, map(torch.device, devices))
               if d.type == "cuda" and (d.index or 0) != (src.index or 0))


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
                           devices: Sequence[DeviceLike]):
    """A render function ``fn(y, u, v) -> (yq, uq, vq)`` that splits the
    batch axis over `devices`: inputs anywhere (the host or a device),
    outputs on ``devices[0]``, in frame order."""
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("no devices to split the batch over")
    fns = [make_render_fn(lut, cfg, d) for d in devs]
    streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
               for d in devs]
    home = devs[0]

    stats = SplitStats(frames=[0] * len(devs))

    def render_part(top, i, fn, dev, stream, planes):
        """Chunk i rendered on its device; on a card, on its own stream,
        with its copy home enqueued."""
        with span("sharding.chunk", top, card=i,
                  frames=int(planes[0].shape[0])):
            if stream is None:
                return fn(*planes)
            # the stream waits for the caller's work on the inputs and for
            # their copy (on the destination's current stream from the host)
            stream.wait_stream(torch.cuda.current_stream(home))
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                for p in planes:
                    p.record_stream(stream)
                done = fn(*planes)
                # a copy runs on the source's current stream: this one
                return [o.to(home, non_blocking=True) for o in done]

    def gather(parts, outs):
        """The chunks' outputs concatenated on the first device, in order;
        on a card, once the caller's stream has waited for every chunk."""
        if home.type != "cuda":
            return tuple(torch.cat([o[k].to(home) for o in outs])
                         for k in range(3))
        caller = torch.cuda.current_stream(home)
        for _, _, _, stream, _ in parts:
            caller.wait_stream(stream)
        for o in outs:
            for t in o:
                t.record_stream(caller)
        return tuple(torch.cat([o[k] for o in outs]) for k in range(3))

    def call(y, u, v):
        src = y.device if isinstance(y, torch.Tensor) else torch.device("cpu")
        with span("sharding.call", cards=len(devs),
                  frames=int(y.shape[0])) as top:
            with span("sharding.put", top):
                chunks = put_sharded(devs, y, u, v)
            # a batch shorter than the device list leaves some devices idle
            parts = [(i, fns[i], devs[i], streams[i], planes)
                     for i, planes in enumerate(zip(*chunks))
                     if planes[0].shape[0]]
            outs = [render_part(top, *part) for part in parts]
            with span("sharding.gather", top):
                res = gather(parts, outs)
            peer = (peer_bytes([p.shape for p in (y, u, v)], y.dtype, src,
                               devs)
                    + peer_bytes([o.shape for o in res], res[0].dtype, home,
                                 devs))
            top.attrs["peer_bytes"] = peer
        stats.calls += 1
        stats.peer_bytes += peer
        for i, _, _, _, planes in parts:
            stats.frames[i] += int(planes[0].shape[0])
        return res

    call.stats = stats
    return call
