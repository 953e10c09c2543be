"""Synthetic media fixtures.

The reference documents lavfi `testsrc=duration=10:size=1920x1080:rate=30`
recipes for manual testing (reference: docs/development.md:214-225) but ships
no generator. Here fixture generation is first-party: deterministic gradient/
test-pattern clips written through cv2's bundled FFmpeg (8-bit H.264/mp4v),
used by the FFI layout self-check, hostio tests, and the benchmark harness.
10-bit fixtures are produced by hostio.encode (prores_ks) once available.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator

import numpy as np


def make_synthetic_frames(
    width: int = 320,
    height: int = 240,
    frames: int = 50,
    pattern: str = "gradient",
    seed: int = 0,
) -> Iterator[np.ndarray]:
    """Yield BGR uint8 frames. Patterns:
    - "gradient": horizontal R ramp, vertical G ramp, temporal B ramp;
    - "noise": deterministic per-frame uniform noise;
    - "zoneplate": concentric rings sweeping with time (chroma stress).
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    for i in range(frames):
        if pattern == "gradient":
            frame = np.zeros((height, width, 3), np.uint8)
            frame[:, :, 2] = np.linspace(0, 255, width, dtype=np.uint8)[None, :]
            frame[:, :, 1] = np.linspace(0, 255, height, dtype=np.uint8)[:, None]
            frame[:, :, 0] = (i * 255 // max(1, frames - 1)) & 0xFF
        elif pattern == "noise":
            frame = rng.integers(0, 256, (height, width, 3), dtype=np.uint8)
        elif pattern == "zoneplate":
            r2 = (xx - width / 2) ** 2 + (yy - height / 2) ** 2
            ph = r2 / (20.0 + i)
            frame = np.stack(
                [
                    (127.5 + 127.5 * np.sin(ph / 7)).astype(np.uint8),
                    (127.5 + 127.5 * np.sin(ph / 11)).astype(np.uint8),
                    (127.5 + 127.5 * np.sin(ph / 17)).astype(np.uint8),
                ],
                axis=-1,
            )
        else:
            raise ValueError(f"unknown pattern {pattern!r}")
        yield frame


def make_10bit_prores_clip(path, width: int = 192, height: int = 108,
                           fps: float = 25.0, frames: int = 12) -> Path:
    """10-bit yuv422p10le ProRes clip with smooth gradients (banding-prone
    content for dither tests), via the in-process encoder."""
    from fractions import Fraction

    from ..hostio.encode import EncoderSettings, VideoEncoder

    path = Path(path)
    st = EncoderSettings(
        codec="prores_ks", width=width, height=height, pix_fmt="yuv422p10le",
        fps=Fraction(int(fps)), profile="3",
        color_primaries="bt709", color_trc="bt709", colorspace="bt709",
        color_range="tv",
    )
    ramp = np.linspace(64, 940, width, dtype=np.uint16)[None, :]
    with VideoEncoder(path, st) as enc:
        for i in range(frames):
            y = np.repeat(ramp + i, height, axis=0).clip(0, 1023).astype(np.uint16)
            u = np.full((height, width // 2), 512 + 4 * i, np.uint16)
            v = np.full((height, width // 2), 512 - 4 * i, np.uint16)
            enc.write(y, u, v)
    return path


def make_fullrange_clip(path, width: int = 128, height: int = 96,
                        fps: float = 25.0, frames: int = 10) -> Path:
    """Legacy full-range clip: MJPEG with yuvj420p, the classic pc-range case
    the policy normalizes (reference ffmpeg.py:129-143 + the yuvj->pc probe
    imputation, media_info.py:145-147)."""
    from fractions import Fraction

    from ..hostio.encode import EncoderSettings, VideoEncoder

    path = Path(path)
    st = EncoderSettings(
        codec="mjpeg", width=width, height=height, pix_fmt="yuvj420p",
        fps=Fraction(int(fps)), qscale=2, color_range="pc",
    )
    with VideoEncoder(path, st) as enc:
        for frame in make_synthetic_frames(width, height, frames):
            y = frame.mean(axis=2).astype(np.uint8)
            u = np.full((height // 2, width // 2), 128, np.uint8)
            v = np.full((height // 2, width // 2), 128, np.uint8)
            enc.write(y, u, v)
    return path


def make_sine_wav(path, seconds: float = 2.0, rate: int = 48000,
                  freq: float = 440.0) -> Path:
    """Stereo 16-bit sine WAV via the stdlib (no codec needed) — the audio
    seed for A/V fixtures."""
    import wave

    path = Path(path)
    n = int(seconds * rate)
    t = np.arange(n) / rate
    tone = (np.sin(2 * np.pi * freq * t) * 12000).astype(np.int16)
    stereo = np.repeat(tone[:, None], 2, axis=1).ravel()
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(stereo.tobytes())
    return path


def make_av_clip(path, width: int = 128, height: int = 96, fps: float = 25.0,
                 frames: int = 50, audio_seconds: float = 2.0) -> Path:
    """Video + PCM audio in one .mov: synthetic frames through the in-process
    encoder with the sine WAV's stream remuxed in."""
    import tempfile
    from fractions import Fraction

    from ..hostio.encode import EncoderSettings, VideoEncoder

    path = Path(path)
    wav = make_sine_wav(
        Path(tempfile.mkdtemp(prefix="luttpu_wav_")) / "tone.wav",
        seconds=audio_seconds,
    )
    st = EncoderSettings(codec="mpeg4", width=width, height=height,
                         pix_fmt="yuv420p", fps=Fraction(int(fps)), bitrate="1M")
    with VideoEncoder(path, st, audio_from=wav) as enc:
        for frame in make_synthetic_frames(width, height, frames):
            y = frame.mean(axis=2).astype(np.uint8)
            u = np.full((height // 2, width // 2), 128, np.uint8)
            v = np.full((height // 2, width // 2), 128, np.uint8)
            enc.write(y, u, v)
    return path


def make_vfr_clip(
    path,
    width: int = 128,
    height: int = 96,
    base_fps: int = 50,
    frames: int = 40,
    pattern: str = "gradient",
) -> Path:
    """Write a variable-frame-rate clip: timestamps alternate 1x/3x the base
    tick, so avg_frame_rate and r_frame_rate diverge and the probe's VFR rule
    (|avg - r| > 0.1, reference media_info.py:138) trips. Uses the in-process
    encoder since cv2 cannot write irregular timestamps."""
    from fractions import Fraction

    import numpy as np

    from ..hostio.encode import EncoderSettings, VideoEncoder

    path = Path(path)
    st = EncoderSettings(
        codec="mpeg4", width=width, height=height, pix_fmt="yuv420p",
        fps=Fraction(base_fps), bitrate="1M",
    )
    pts = 0
    with VideoEncoder(path, st) as enc:
        for i, frame in enumerate(
            make_synthetic_frames(width, height, frames, pattern)
        ):
            # frame is BGR; take a cheap luma-ish plane split
            y = frame.mean(axis=2).astype(np.uint8)
            u = np.full((height // 2, width // 2), 128, np.uint8)
            v = np.full((height // 2, width // 2), 128, np.uint8)
            enc.write(y, u, v, pts=pts)
            pts += 1 if i % 2 == 0 else 3
    return path


def make_gradient_clip(
    path,
    width: int = 320,
    height: int = 240,
    fps: float = 25.0,
    frames: int = 50,
    pattern: str = "gradient",
    fourcc: str = "mp4v",
) -> Path:
    """Write a synthetic 8-bit clip via cv2 (bundled FFmpeg). Deterministic."""
    import cv2

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    vw = cv2.VideoWriter(
        str(path), cv2.VideoWriter_fourcc(*fourcc), fps, (width, height)
    )
    if not vw.isOpened():
        raise RuntimeError(f"cv2.VideoWriter failed to open {path}")
    for frame in make_synthetic_frames(width, height, frames, pattern):
        vw.write(frame)
    vw.release()
    if not path.exists() or path.stat().st_size == 0:
        raise RuntimeError(f"fixture write produced no data: {path}")
    return path
