"""Frame scheduler: VFR->CFR timestamp rewriting on the host side.

Implements the dup/drop semantics of FFmpeg's `-fps_mode cfr -r <rate>`
(emitted by the reference policy at src/lut_renderer/ffmpeg.py:258-285):
output frames tick at k/fps; each tick emits the most recent input frame
whose timestamp has been reached (duplicating when input is slow, dropping
when input is fast). In passthrough mode frames stream through unchanged.

The port's copy of lut_renderer_tpu/engine/scheduler.py.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Iterator, Optional

from ..hostio.decode import DecodedFrame


class FrameScheduler:
    def __init__(self, mode: str, fps: Fraction):
        if mode not in ("cfr", "passthrough"):
            raise ValueError(f"unknown fps_mode {mode!r}")
        self.mode = mode
        self.fps = fps

    def schedule(self, frames: Iterator[DecodedFrame]) -> Iterator[DecodedFrame]:
        if self.mode == "passthrough":
            yield from frames
            return
        yield from self._cfr(frames)

    def _cfr(self, frames: Iterator[DecodedFrame]) -> Iterator[DecodedFrame]:
        period = 1.0 / float(self.fps)
        half = period / 2.0
        tick = 0
        prev: Optional[DecodedFrame] = None
        for frame in frames:
            ts = frame.pts_seconds
            if ts is None:
                # No timestamps: degrade to 1:1 passthrough at the target rate.
                yield frame
                tick += 1
                continue
            if prev is None:
                prev = frame
                continue
            # emit prev for every tick strictly before this frame's midpoint
            while tick * period + half <= ts:
                yield prev
                tick += 1
            prev = frame
        if prev is not None:
            yield prev
