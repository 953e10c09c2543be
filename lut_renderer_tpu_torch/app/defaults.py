"""Smart parameter defaults and mode templates.

Reference behaviors:
  * blank resolution/bitrate are filled from the probe when the codec isn't
    copy (main_window.py:1652, 1666-1672, 2576-2580);
  * selecting copy-codec while a LUT is active auto-switches to an encoding
    codec (main_window.py:1136-1147, 2581-2583);
  * fast/pro mode templates (main_window.py:1078-1098); the reference prefers
    h264_videotoolbox on macOS — here the preference order is adapted to the
    encoders actually present in the bundled libs, falling back gracefully
    (the reference itself does no availability check, readme.md:117).
"""

from __future__ import annotations

from typing import Optional

from ..models import ProcessingParams, VideoInfo

_FAST_CODEC_PREFERENCE = ["libx264", "h264_videotoolbox", "mpeg4", "libvpx-vp9"]
_FALLBACK_ENCODE_CODEC = "libx264"


def _first_available_codec() -> str:
    try:
        from ..hostio.encode import list_encoders

        available = set(list_encoders(_FAST_CODEC_PREFERENCE))
        for name in _FAST_CODEC_PREFERENCE:
            if name in available:
                return name
    except Exception:
        pass
    return _FALLBACK_ENCODE_CODEC


def apply_smart_defaults(
    params: ProcessingParams,
    info: Optional[VideoInfo],
    lut_active: bool = False,
) -> ProcessingParams:
    """Return a copy of params with probe-driven defaults applied."""
    p = params.copy()
    if lut_active and p.video_codec == "copy":
        p.video_codec = _first_available_codec()
    if info and p.video_codec != "copy":
        if not p.resolution and info.resolution:
            p.resolution = info.resolution
        if not p.bitrate and info.bitrate:
            p.bitrate = info.bitrate
    return p


def mode_template(mode: str, prefer_available: bool = True) -> ProcessingParams:
    """Template parameter sets for the two processing modes."""
    codec = _first_available_codec() if prefer_available else "libx264"
    if mode == "pro":
        return ProcessingParams(
            processing_mode="pro",
            video_codec=codec,
            audio_codec="copy",
            bit_depth_policy="preserve",
            faststart=True,
        )
    return ProcessingParams(
        processing_mode="fast",
        video_codec=codec,
        audio_codec="copy",
        bit_depth_policy="preserve",
    )
