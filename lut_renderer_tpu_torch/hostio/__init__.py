"""hostio — native media layer over the FFmpeg shared libraries bundled with
opencv-python (no ffmpeg/ffprobe binaries exist in this environment).

Replaces the reference's process boundaries:
  probe   <- ffprobe subprocess   (reference: src/lut_renderer/media_info.py:113-126)
  decode  <- ffmpeg demux/decode  (task_manager.py:145-151)
  encode  <- ffmpeg encoders/mux  (ffmpeg.py argv -> encoders)

All of it binds through ctypes with runtime-verified struct layouts (ffi.py);
field writes go through the libraries' own AVOptions tables wherever possible
so no header files are needed.
"""

from .ffi import FFmpegFFI, FFIUnavailable, MediaError, get_ffi
from .probe import probe_video
from .decode import VideoDecoder
from .encode import VideoEncoder, EncoderSettings, list_encoders

__all__ = [
    "FFmpegFFI",
    "FFIUnavailable",
    "MediaError",
    "get_ffi",
    "probe_video",
    "VideoDecoder",
    "VideoEncoder",
    "EncoderSettings",
    "list_encoders",
]
