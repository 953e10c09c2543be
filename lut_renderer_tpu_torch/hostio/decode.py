"""In-process video decoding via the bundled libavcodec/libavformat.

Replaces the decode half of the reference's external FFmpeg process
(src/lut_renderer/task_manager.py:145-151). Emits contiguous planar numpy
arrays (Y, U, V) at the stream's native bit depth (uint8 / uint16-LE for
10-bit), plus frame timestamps — exactly the layout the TPU render op wants.
"""

from __future__ import annotations

from ctypes import byref, c_void_p, memmove
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

from .ffi import (
    AV_NOPTS_VALUE,
    AVERROR_EAGAIN,
    AVERROR_EOF,
    AVMEDIA_TYPE_VIDEO,
    MediaError,
    OFF,
    Rational,
    _r_i32,
    _r_i64,
    _r_ptr,
    _r_rational,
    get_ffi,
)

# Planar YUV formats we hand straight to the TPU path:
# name -> (bit_depth, chroma_w_shift, chroma_h_shift, full_range_legacy)
_PLANAR_FMTS = {
    "yuv420p": (8, 1, 1, False),
    "yuvj420p": (8, 1, 1, True),
    "yuv422p": (8, 1, 0, False),
    "yuvj422p": (8, 1, 0, True),
    "yuv444p": (8, 0, 0, False),
    "yuvj444p": (8, 0, 0, True),
    "yuv420p10le": (10, 1, 1, False),
    "yuv422p10le": (10, 1, 0, False),
    "yuv444p10le": (10, 0, 0, False),
    "yuv420p12le": (12, 1, 1, False),
    "yuv422p12le": (12, 1, 0, False),
}


@dataclass
class DecodedFrame:
    index: int
    pts: Optional[int]          # in stream time_base units
    pts_seconds: Optional[float]
    y: np.ndarray               # (H, W)
    u: np.ndarray               # chroma plane at native subsampling
    v: np.ndarray
    pix_fmt: str
    bit_depth: int
    full_range_hint: bool       # yuvj* legacy formats


def _copy_plane(data_ptr: int, linesize: int, h: int, w: int, itemsize: int) -> np.ndarray:
    """Copy a possibly-strided plane into a contiguous (h, w) array."""
    dtype = np.uint8 if itemsize == 1 else np.uint16
    row_bytes = w * itemsize
    out = np.empty((h, w), dtype)
    if linesize == row_bytes:
        memmove(out.ctypes.data, data_ptr, row_bytes * h)
    else:
        for r in range(h):
            memmove(out.ctypes.data + r * row_bytes, data_ptr + r * linesize, row_bytes)
    return out


class VideoDecoder:
    """Sequential decoder for one file's best video stream.

    Usage:
        with VideoDecoder(path) as dec:
            for frame in dec:
                ...
    """

    def __init__(self, path, threads: str = "auto"):
        self.path = Path(path)
        if not self.path.exists():
            raise FileNotFoundError(str(self.path))
        self.ffi = get_ffi()
        f = self.ffi.avformat
        self._fmt = c_void_p(0)
        self.ffi.check(
            f.avformat_open_input(byref(self._fmt), str(self.path).encode(), None, None),
            "avformat_open_input",
        )
        try:
            self.ffi.check(
                f.avformat_find_stream_info(self._fmt, None), "find_stream_info"
            )
            dec = c_void_p(0)
            self.stream_index = self.ffi.check(
                f.av_find_best_stream(
                    self._fmt, AVMEDIA_TYPE_VIDEO, -1, -1, byref(dec), 0
                ),
                "no video stream",
            )
            streams = _r_ptr(self._fmt.value, OFF["fmt_streams"])
            self._st = _r_ptr(streams, 8 * self.stream_index)
            par = _r_ptr(self._st, OFF["st_codecpar"])
            self.width = _r_i32(par, OFF["par_width"])
            self.height = _r_i32(par, OFF["par_height"])
            self.time_base = _r_rational(self._st, OFF["st_time_base"])

            self._ctx = self.ffi.avcodec.avcodec_alloc_context3(dec)
            self.ffi.check(
                self.ffi.avcodec.avcodec_parameters_to_context(
                    c_void_p(self._ctx), c_void_p(par)
                ),
                "parameters_to_context",
            )
            self.ffi.opt_set(self._ctx, "threads", threads)
            self.ffi.check(
                self.ffi.avcodec.avcodec_open2(c_void_p(self._ctx), dec, None),
                "avcodec_open2",
            )
            self._pkt = self.ffi.avcodec.av_packet_alloc()
            self._frm = self.ffi.avutil.av_frame_alloc()
            self._eof_sent = False
            self._index = 0
            self._closed = False
        except Exception:
            f.avformat_close_input(byref(self._fmt))
            raise

    # -- iteration ----------------------------------------------------------
    def __iter__(self) -> Iterator[DecodedFrame]:
        while True:
            frame = self.read_frame()
            if frame is None:
                return
            yield frame

    def read_frame(self) -> Optional[DecodedFrame]:
        ffi = self.ffi
        ac = ffi.avcodec
        while True:
            r = ac.avcodec_receive_frame(c_void_p(self._ctx), c_void_p(self._frm))
            if r == 0:
                return self._extract()
            if r == AVERROR_EOF:
                return None
            if r != AVERROR_EAGAIN:
                ffi.check(r, "receive_frame")
            if self._eof_sent:
                return None
            # feed more packets
            while True:
                rr = ffi.avformat.av_read_frame(self._fmt, c_void_p(self._pkt))
                if rr < 0:
                    ac.avcodec_send_packet(c_void_p(self._ctx), None)
                    self._eof_sent = True
                    break
                if _r_i32(self._pkt, OFF["pkt_stream_index"]) == self.stream_index:
                    ffi.check(
                        ac.avcodec_send_packet(c_void_p(self._ctx), c_void_p(self._pkt)),
                        "send_packet",
                    )
                    ac.av_packet_unref(c_void_p(self._pkt))
                    break
                ac.av_packet_unref(c_void_p(self._pkt))

    def _extract(self) -> DecodedFrame:
        ffi = self.ffi
        frm = self._frm
        w = _r_i32(frm, OFF["frame_width"])
        h = _r_i32(frm, OFF["frame_height"])
        fmt_id = _r_i32(frm, OFF["frame_format"])
        fmt = ffi.pix_fmt_name(fmt_id) or f"#{fmt_id}"
        if fmt not in _PLANAR_FMTS:
            raise MediaError(
                f"unsupported decoded pix_fmt {fmt!r} (planar YUV expected)"
            )
        depth, cws, chs, legacy_full = _PLANAR_FMTS[fmt]
        itemsize = 1 if depth <= 8 else 2
        cw = -(-w >> cws) if cws else w
        ch = -(-h >> chs) if chs else h

        planes = []
        for i in range(3):
            data = _r_ptr(frm, OFF["frame_data"] + 8 * i)
            ls = _r_i32(frm, OFF["frame_linesize"] + 4 * i)
            pw, ph = (w, h) if i == 0 else (cw, ch)
            planes.append(_copy_plane(data, ls, ph, pw, itemsize))

        pts = _r_i64(frm, OFF["frame_pts"])
        if pts == AV_NOPTS_VALUE:
            pts = _r_i64(frm, OFF["frame_pkt_dts"])
        pts_val = None if pts == AV_NOPTS_VALUE else pts
        secs = (
            pts_val * self.time_base.num / self.time_base.den
            if pts_val is not None and self.time_base.den
            else None
        )
        ffi.avutil.av_frame_unref(c_void_p(self._frm))
        out = DecodedFrame(
            index=self._index,
            pts=pts_val,
            pts_seconds=secs,
            y=planes[0],
            u=planes[1],
            v=planes[2],
            pix_fmt=fmt,
            bit_depth=depth,
            full_range_hint=legacy_full,
        )
        self._index += 1
        return out

    # -- lifecycle ----------------------------------------------------------
    def close(self):
        if self._closed:
            return
        self._closed = True
        ffi = self.ffi
        p = c_void_p(self._pkt)
        ffi.avcodec.av_packet_free(byref(p))
        fp = c_void_p(self._frm)
        ffi.avutil.av_frame_free(byref(fp))
        cp = c_void_p(self._ctx)
        ffi.avcodec.avcodec_free_context(byref(cp))
        ffi.avformat.avformat_close_input(byref(self._fmt))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
