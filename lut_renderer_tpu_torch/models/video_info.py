"""VideoInfo: probe result data model.

Field set and semantics mirror the reference's probe contract
(reference: src/lut_renderer/media_info.py:12-52) so that policy decisions made
on top of it (bit-depth, range, VFR, color tags) carry over one-to-one:

  * `is_vfr` uses the |avg_fps - r_fps| > 0.1 rule (media_info.py:9,138);
  * yuvj* pixel formats impute color_range="pc" (media_info.py:145-147);
  * bitrates are normalized to "<n>k" strings (media_info.py:158-174);
  * bit depth comes from bits_per_raw_sample, else the digits after 'p' in the
    pixel format name (media_info.py:86-110);
  * "unknown"/"unspecified" color tags are dropped to None (media_info.py:77-83).

The helpers here are pure; actual probing lives in hostio.probe.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

FPS_EPSILON = 0.1


@dataclass
class VideoInfo:
    width: Optional[int] = None
    height: Optional[int] = None
    sar: Optional[str] = None
    dar: Optional[str] = None
    bitrate: Optional[str] = None
    container_bitrate: Optional[str] = None
    fps: Optional[float] = None
    avg_fps: Optional[float] = None
    r_fps: Optional[float] = None
    is_vfr: bool = False
    duration: Optional[float] = None
    pix_fmt: Optional[str] = None
    bit_depth: Optional[int] = None
    codec_name: Optional[str] = None
    codec_long_name: Optional[str] = None
    profile: Optional[str] = None
    level: Optional[str] = None
    color_primaries: Optional[str] = None
    color_trc: Optional[str] = None
    colorspace: Optional[str] = None
    color_range: Optional[str] = None
    format_name: Optional[str] = None
    format_long_name: Optional[str] = None
    file_size: Optional[int] = None
    audio_codec: Optional[str] = None
    audio_codec_long_name: Optional[str] = None
    audio_channels: Optional[int] = None
    audio_channel_layout: Optional[str] = None
    audio_sample_rate: Optional[int] = None
    audio_bitrate: Optional[str] = None
    nb_frames: Optional[int] = None
    format_tags: Optional[dict] = None
    video_tags: Optional[dict] = None
    audio_tags: Optional[dict] = None

    @property
    def resolution(self) -> Optional[str]:
        if self.width and self.height:
            return f"{self.width}x{self.height}"
        return None

    @property
    def is_full_range(self) -> bool:
        """Full-range detection rule of the policy engine
        (reference: src/lut_renderer/ffmpeg.py:129-134)."""
        if self.pix_fmt and str(self.pix_fmt).startswith("yuvj"):
            return True
        return bool(self.color_range and str(self.color_range).lower() == "pc")


def parse_fraction(value: Optional[str]) -> Optional[float]:
    """Parse 'num/den' or plain float strings; None/0-denominator -> None."""
    if not value:
        return None
    text = str(value).strip()
    if not text or text == "0/0":
        return None
    if "/" in text:
        num_s, den_s = text.split("/", 1)
        try:
            num, den = float(num_s), float(den_s)
        except ValueError:
            return None
        if den == 0:
            return None
        return num / den
    try:
        return float(text)
    except ValueError:
        return None


def normalize_color(value: Optional[str]) -> Optional[str]:
    if not value:
        return None
    cleaned = str(value).strip()
    if not cleaned or cleaned.lower() in {"unknown", "unspecified", "unknown/unknown"}:
        return None
    return cleaned


def infer_bit_depth(pix_fmt: Optional[str], bits_per_raw_sample=None) -> Optional[int]:
    if bits_per_raw_sample:
        try:
            bits = int(float(bits_per_raw_sample))
            if bits > 0:
                return bits
        except (TypeError, ValueError):
            pass
    if not pix_fmt:
        return None
    for token in str(pix_fmt).split(":"):
        if "p" in token:
            idx = token.find("p")
            digits = ""
            for ch in token[idx + 1:]:
                if ch.isdigit():
                    digits += ch
                else:
                    break
            if digits:
                try:
                    return int(digits)
                except ValueError:
                    return None
    return None


def detect_vfr(avg_fps: Optional[float], r_fps: Optional[float]) -> bool:
    return bool(avg_fps and r_fps and abs(avg_fps - r_fps) > FPS_EPSILON)


def kbps_string(bits_value) -> Optional[str]:
    """Normalize a bits/sec value to the '<n>k' string form used everywhere."""
    if bits_value in (None, "", 0):
        return None
    try:
        bits = int(float(bits_value))
    except (TypeError, ValueError):
        return None
    if bits <= 0:
        return None
    return f"{max(1, round(bits / 1000))}k"
