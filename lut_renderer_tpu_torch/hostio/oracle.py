"""FFmpeg `lut3d` oracle: runs the reference's actual pixel engine in-process.

The reference applies LUTs exclusively through FFmpeg's lut3d filter
(src/lut_renderer/ffmpeg.py:242-247). This module drives that exact C
implementation from the bundled libavfilter via a buffer -> lut3d ->
buffersink graph, for two purposes:

  * parity: max dE76 between the TPU kernel and lut3d is the headline
    correctness metric (BASELINE.md) — measured on float planes (gbrpf32)
    so quantization doesn't mask kernel differences;
  * baseline: lut3d's single-core throughput on this host is the measured
    "FFmpeg-CPU" number the >=5x target is defined against (rgb48le, the
    format FFmpeg actually uses for 8/10-bit video through lut3d).
"""

from __future__ import annotations

import time
from ctypes import POINTER, byref, c_char_p, c_int, c_void_p, memmove
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .ffi import (
    AVERROR_EAGAIN,
    MediaError,
    OFF,
    _r_i32,
    _r_i64,
    _r_ptr,
    _w_i32,
    _w_i64,
    get_ffi,
)


class Lut3DOracle:
    """One configured lut3d filter graph, reusable across frames."""

    def __init__(self, cube_path, interp: str = "tetrahedral",
                 pix_fmt: str = "gbrpf32le", width: int = 256,
                 height: int = 256):
        self.ffi = get_ffi()
        ffi = self.ffi
        af = ffi.avfilter
        af.avfilter_graph_alloc.restype = c_void_p
        af.avfilter_get_by_name.restype = c_void_p
        af.avfilter_get_by_name.argtypes = [c_char_p]
        af.avfilter_graph_create_filter.argtypes = [
            POINTER(c_void_p), c_void_p, c_char_p, c_char_p, c_void_p, c_void_p,
        ]
        af.avfilter_graph_create_filter.restype = c_int
        af.avfilter_link.argtypes = [c_void_p, c_int, c_void_p, c_int]
        af.avfilter_link.restype = c_int
        af.avfilter_graph_config.argtypes = [c_void_p, c_void_p]
        af.avfilter_graph_config.restype = c_int
        af.av_buffersrc_add_frame_flags.argtypes = [c_void_p, c_void_p, c_int]
        af.av_buffersrc_add_frame_flags.restype = c_int
        af.av_buffersink_get_frame.argtypes = [c_void_p, c_void_p]
        af.av_buffersink_get_frame.restype = c_int
        af.avfilter_graph_free.argtypes = [POINTER(c_void_p)]

        self.width = width
        self.height = height
        self.pix_fmt = pix_fmt
        self.fmt_id = ffi.pix_fmt_id(pix_fmt)
        if self.fmt_id < 0:
            raise MediaError(f"unknown pix_fmt {pix_fmt}")

        self._graph = c_void_p(af.avfilter_graph_alloc())
        if not self._graph.value:
            raise MediaError("avfilter_graph_alloc failed")
        try:
            buf = af.avfilter_get_by_name(b"buffer")
            sink = af.avfilter_get_by_name(b"buffersink")
            lut3d = af.avfilter_get_by_name(b"lut3d")
            if not (buf and sink and lut3d):
                raise MediaError("buffer/buffersink/lut3d filters missing")

            self._src = c_void_p(0)
            args = (
                f"video_size={width}x{height}:pix_fmt={self.fmt_id}:"
                f"time_base=1/25:pixel_aspect=1/1"
            ).encode()
            ffi.check(
                af.avfilter_graph_create_filter(
                    byref(self._src), c_void_p(buf), b"in", args, None, self._graph
                ),
                "create buffer source",
            )
            self._lut = c_void_p(0)
            escaped = str(Path(cube_path)).replace("\\", "\\\\").replace("'", "\\'")
            largs = f"file='{escaped}':interp={interp}".encode()
            ffi.check(
                af.avfilter_graph_create_filter(
                    byref(self._lut), c_void_p(lut3d), b"lut", largs, None, self._graph
                ),
                "create lut3d",
            )
            self._sink = c_void_p(0)
            ffi.check(
                af.avfilter_graph_create_filter(
                    byref(self._sink), c_void_p(sink), b"out", None, None, self._graph
                ),
                "create buffersink",
            )
            ffi.check(af.avfilter_link(self._src, 0, self._lut, 0), "link src->lut")
            ffi.check(af.avfilter_link(self._lut, 0, self._sink, 0), "link lut->sink")
            ffi.check(af.avfilter_graph_config(self._graph, None), "graph_config")

            self._frm = ffi.avutil.av_frame_alloc()
            _w_i32(self._frm, OFF["frame_width"], width)
            _w_i32(self._frm, OFF["frame_height"], height)
            _w_i32(self._frm, OFF["frame_format"], self.fmt_id)
            ffi.check(
                ffi.avutil.av_frame_get_buffer(c_void_p(self._frm), 0),
                "frame_get_buffer",
            )
            self._out = ffi.avutil.av_frame_alloc()
            self._pts = 0
        except Exception:
            af.avfilter_graph_free(byref(self._graph))
            raise

    # ------------------------------------------------------------------
    def _fill_and_run(self, fill_fn, read_fn):
        ffi = self.ffi
        ffi.check(
            ffi.avutil.av_frame_make_writable(c_void_p(self._frm)),
            "frame_make_writable",
        )
        fill_fn(self._frm)
        _w_i64(self._frm, OFF["frame_pts"], self._pts)
        self._pts += 1
        # AV_BUFFERSRC_FLAG_KEEP_REF = 8 (keep our reusable input frame)
        ffi.check(
            ffi.avfilter.av_buffersrc_add_frame_flags(
                self._src, c_void_p(self._frm), 8
            ),
            "buffersrc_add_frame",
        )
        r = ffi.avfilter.av_buffersink_get_frame(self._sink, c_void_p(self._out))
        if r == AVERROR_EAGAIN:
            raise MediaError("lut3d produced no frame")
        ffi.check(r, "buffersink_get_frame")
        try:
            return read_fn(self._out)
        finally:
            ffi.avutil.av_frame_unref(c_void_p(self._out))

    def apply_rgb_float(self, rgb: np.ndarray) -> np.ndarray:
        """(H, W, 3) float32 in [0,1] -> lut3d output, via gbrpf32 planes."""
        h, w = rgb.shape[:2]
        assert (h, w) == (self.height, self.width)
        assert self.pix_fmt.startswith("gbrpf32")
        planes = {
            0: np.ascontiguousarray(rgb[..., 1], np.float32),  # G
            1: np.ascontiguousarray(rgb[..., 2], np.float32),  # B
            2: np.ascontiguousarray(rgb[..., 0], np.float32),  # R
        }

        def fill(frm):
            for i, arr in planes.items():
                data = _r_ptr(frm, OFF["frame_data"] + 8 * i)
                ls = _r_i32(frm, OFF["frame_linesize"] + 4 * i)
                row = w * 4
                if ls == row:
                    memmove(data, arr.ctypes.data, row * h)
                else:
                    for r_ in range(h):
                        memmove(data + r_ * ls, arr.ctypes.data + r_ * row, row)

        def read(frm):
            out = np.empty((h, w, 3), np.float32)
            order = {0: 1, 1: 2, 2: 0}  # plane idx -> rgb channel
            for i, ch in order.items():
                data = _r_ptr(frm, OFF["frame_data"] + 8 * i)
                ls = _r_i32(frm, OFF["frame_linesize"] + 4 * i)
                plane = np.empty((h, w), np.float32)
                row = w * 4
                if ls == row:
                    memmove(plane.ctypes.data, data, row * h)
                else:
                    for r_ in range(h):
                        memmove(plane.ctypes.data + r_ * row, data + r_ * ls, row)
                out[..., ch] = plane
            return out

        return self._fill_and_run(fill, read)

    def apply_rgb48(self, rgb16: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint16 -> lut3d output (rgb48le packed), the realistic
        8/10-bit video path; used for throughput measurement."""
        h, w = rgb16.shape[:2]
        assert self.pix_fmt == "rgb48le"
        packed = np.ascontiguousarray(rgb16, np.uint16)

        def fill(frm):
            data = _r_ptr(frm, OFF["frame_data"])
            ls = _r_i32(frm, OFF["frame_linesize"])
            row = w * 6
            if ls == row:
                memmove(data, packed.ctypes.data, row * h)
            else:
                for r_ in range(h):
                    memmove(data + r_ * ls, packed.ctypes.data + r_ * row, row)

        def read(frm):
            out = np.empty((h, w, 3), np.uint16)
            data = _r_ptr(frm, OFF["frame_data"])
            ls = _r_i32(frm, OFF["frame_linesize"])
            row = w * 6
            if ls == row:
                memmove(out.ctypes.data, data, row * h)
            else:
                for r_ in range(h):
                    memmove(out.ctypes.data + r_ * row, data + r_ * ls, row)
            return out

        return self._fill_and_run(fill, read)

    def close(self):
        if getattr(self, "_graph", None) and self._graph.value:
            if getattr(self, "_frm", None):
                p = c_void_p(self._frm)
                self.ffi.avutil.av_frame_free(byref(p))
                self._frm = None
            if getattr(self, "_out", None):
                p = c_void_p(self._out)
                self.ffi.avutil.av_frame_free(byref(p))
                self._out = None
            self.ffi.avfilter.avfilter_graph_free(byref(self._graph))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class ChainOracle:
    """FFmpeg filter-CHAIN oracle: the reference's complete video pipeline
    (src/lut_renderer/ffmpeg.py:195-247,304-310 — scale range/matrix ->
    format -> lut3d -> format) run through the bundled libavfilter on planar
    YUV frames, yuv in -> yuv out.

    This is the end-to-end twin of Lut3DOracle (which isolates the kernel on
    RGB planes): it exercises everything the reference delegates to FFmpeg —
    chroma up/down-sampling siting, the fixed-point YUV<->RGB conversions,
    range normalization, and quantization placement — so the fused TPU
    render can be parity-checked against the full reference behavior, not
    just the LUT core (tests/test_chain_parity.py).

    `filters` is an ordered list of (name, args) pairs linked between a
    buffer source and buffersink; libavfilter auto-inserts the same format
    negotiation conversions the ffmpeg CLI would.
    """

    def __init__(self, width: int, height: int, filters, pix_fmt: str = "yuv420p"):
        self.ffi = ffi = get_ffi()
        af = ffi.avfilter
        af.avfilter_graph_alloc.restype = c_void_p
        af.avfilter_get_by_name.restype = c_void_p
        af.avfilter_get_by_name.argtypes = [c_char_p]
        af.avfilter_graph_create_filter.argtypes = [
            POINTER(c_void_p), c_void_p, c_char_p, c_char_p, c_void_p, c_void_p,
        ]
        af.avfilter_graph_create_filter.restype = c_int
        af.avfilter_link.argtypes = [c_void_p, c_int, c_void_p, c_int]
        af.avfilter_link.restype = c_int
        af.avfilter_graph_config.argtypes = [c_void_p, c_void_p]
        af.avfilter_graph_config.restype = c_int
        af.av_buffersrc_add_frame_flags.argtypes = [c_void_p, c_void_p, c_int]
        af.av_buffersrc_add_frame_flags.restype = c_int
        af.av_buffersink_get_frame.argtypes = [c_void_p, c_void_p]
        af.av_buffersink_get_frame.restype = c_int
        af.avfilter_graph_free.argtypes = [POINTER(c_void_p)]

        self.width, self.height = width, height
        self.pix_fmt = pix_fmt
        self.fmt_id = ffi.pix_fmt_id(pix_fmt)
        if self.fmt_id < 0:
            raise MediaError(f"unknown pix_fmt {pix_fmt}")

        self._graph = c_void_p(af.avfilter_graph_alloc())
        if not self._graph.value:
            raise MediaError("avfilter_graph_alloc failed")
        try:
            buf = af.avfilter_get_by_name(b"buffer")
            sink = af.avfilter_get_by_name(b"buffersink")
            if not (buf and sink):
                raise MediaError("buffer/buffersink filters missing")
            self._src = c_void_p(0)
            args = (
                f"video_size={width}x{height}:pix_fmt={self.fmt_id}:"
                f"time_base=1/25:pixel_aspect=1/1"
            ).encode()
            ffi.check(
                af.avfilter_graph_create_filter(
                    byref(self._src), c_void_p(buf), b"in", args, None,
                    self._graph),
                "create buffer source",
            )
            prev = self._src
            for idx, (name, fargs) in enumerate(filters):
                fptr = af.avfilter_get_by_name(name.encode())
                if not fptr:
                    raise MediaError(f"filter {name!r} missing")
                ctx = c_void_p(0)
                ffi.check(
                    af.avfilter_graph_create_filter(
                        byref(ctx), c_void_p(fptr), f"f{idx}".encode(),
                        fargs.encode() if fargs else None, None, self._graph),
                    f"create {name}",
                )
                ffi.check(af.avfilter_link(prev, 0, ctx, 0), f"link->{name}")
                prev = ctx
            self._sink = c_void_p(0)
            ffi.check(
                af.avfilter_graph_create_filter(
                    byref(self._sink), c_void_p(sink), b"out", None, None,
                    self._graph),
                "create buffersink",
            )
            ffi.check(af.avfilter_link(prev, 0, self._sink, 0), "link->sink")
            ffi.check(af.avfilter_graph_config(self._graph, None),
                      "graph_config")

            self._frm = ffi.avutil.av_frame_alloc()
            _w_i32(self._frm, OFF["frame_width"], width)
            _w_i32(self._frm, OFF["frame_height"], height)
            _w_i32(self._frm, OFF["frame_format"], self.fmt_id)
            ffi.check(
                ffi.avutil.av_frame_get_buffer(c_void_p(self._frm), 0),
                "frame_get_buffer",
            )
            self._out = ffi.avutil.av_frame_alloc()
            self._pts = 0
        except Exception:
            af.avfilter_graph_free(byref(self._graph))
            raise

    @staticmethod
    def _plane_dims(pix_fmt: str, w: int, h: int, idx: int):
        if idx == 0:
            return h, w
        if pix_fmt.startswith("yuv420"):
            return h // 2, w // 2
        if pix_fmt.startswith("yuv422"):
            return h, w // 2
        return h, w  # 444

    def apply_yuv(self, y: np.ndarray, u: np.ndarray, v: np.ndarray):
        """uint8 (or uint16 for 10-bit fmts) planar YUV in -> planar YUV out
        (tuple of arrays; output geometry follows the sink's negotiated
        format, asserted to equal the input pix_fmt family)."""
        ffi = self.ffi
        itemsize = y.dtype.itemsize
        planes = (np.ascontiguousarray(y), np.ascontiguousarray(u),
                  np.ascontiguousarray(v))
        ffi.check(
            ffi.avutil.av_frame_make_writable(c_void_p(self._frm)),
            "frame_make_writable",
        )
        for i, arr in enumerate(planes):
            data = _r_ptr(self._frm, OFF["frame_data"] + 8 * i)
            ls = _r_i32(self._frm, OFF["frame_linesize"] + 4 * i)
            ph, pw = arr.shape
            row = pw * itemsize
            if ls == row:
                memmove(data, arr.ctypes.data, row * ph)
            else:
                for r_ in range(ph):
                    memmove(data + r_ * ls, arr.ctypes.data + r_ * row, row)
        _w_i64(self._frm, OFF["frame_pts"], self._pts)
        self._pts += 1
        ffi.check(
            ffi.avfilter.av_buffersrc_add_frame_flags(
                self._src, c_void_p(self._frm), 8),
            "buffersrc_add_frame",
        )
        r = ffi.avfilter.av_buffersink_get_frame(self._sink, c_void_p(self._out))
        if r == AVERROR_EAGAIN:
            raise MediaError("chain produced no frame")
        ffi.check(r, "buffersink_get_frame")
        try:
            ow = _r_i32(self._out, OFF["frame_width"])
            oh = _r_i32(self._out, OFF["frame_height"])
            ofmt = _r_i32(self._out, OFF["frame_format"])
            if ofmt != self.fmt_id:
                # plane dims/dtype below are derived from self.pix_fmt; a
                # sink that negotiated a different format would be read as
                # garbage and poison parity numbers — fail loudly instead.
                raise MediaError(
                    f"chain sink negotiated pix_fmt id {ofmt}, expected "
                    f"{self.fmt_id} ({self.pix_fmt})")
            outs = []
            for i in range(3):
                ph, pw = self._plane_dims(self.pix_fmt, ow, oh, i)
                arr = np.empty((ph, pw), planes[i].dtype)
                data = _r_ptr(self._out, OFF["frame_data"] + 8 * i)
                ls = _r_i32(self._out, OFF["frame_linesize"] + 4 * i)
                row = pw * itemsize
                if ls == row:
                    memmove(arr.ctypes.data, data, row * ph)
                else:
                    for r_ in range(ph):
                        memmove(arr.ctypes.data + r_ * row, data + r_ * ls, row)
                outs.append(arr)
            return tuple(outs)
        finally:
            ffi.avutil.av_frame_unref(c_void_p(self._out))

    def close(self):
        if getattr(self, "_graph", None) and self._graph.value:
            if getattr(self, "_frm", None):
                p = c_void_p(self._frm)
                self.ffi.avutil.av_frame_free(byref(p))
                self._frm = None
            if getattr(self, "_out", None):
                p = c_void_p(self._out)
                self.ffi.avutil.av_frame_free(byref(p))
                self._out = None
            self.ffi.avfilter.avfilter_graph_free(byref(self._graph))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class ScaleOracle:
    """FFmpeg `scale` (swscale) oracle: buffer -> scale=W:H:flags=... ->
    buffersink on a single gray plane.

    The reference's `-s WxH` runs swscale's default SWS_BICUBIC scaler
    (src/lut_renderer/ffmpeg.py:312-313); this drives that exact C code for
    parity tests of ops.resample (grayf32le keeps quantization out of the
    comparison). Separable, so gray-plane parity covers the RGB case.
    """

    def __init__(self, in_w: int, in_h: int, out_w: int, out_h: int,
                 flags: str = "bicubic", pix_fmt: str = "grayf32le"):
        self.ffi = ffi = get_ffi()
        af = ffi.avfilter
        af.avfilter_graph_alloc.restype = c_void_p
        af.avfilter_get_by_name.restype = c_void_p
        af.avfilter_get_by_name.argtypes = [c_char_p]
        af.avfilter_graph_create_filter.argtypes = [
            POINTER(c_void_p), c_void_p, c_char_p, c_char_p, c_void_p, c_void_p,
        ]
        af.avfilter_graph_create_filter.restype = c_int
        af.avfilter_link.argtypes = [c_void_p, c_int, c_void_p, c_int]
        af.avfilter_link.restype = c_int
        af.avfilter_graph_config.argtypes = [c_void_p, c_void_p]
        af.avfilter_graph_config.restype = c_int
        af.av_buffersrc_add_frame_flags.argtypes = [c_void_p, c_void_p, c_int]
        af.av_buffersrc_add_frame_flags.restype = c_int
        af.av_buffersink_get_frame.argtypes = [c_void_p, c_void_p]
        af.av_buffersink_get_frame.restype = c_int
        af.avfilter_graph_free.argtypes = [POINTER(c_void_p)]

        self.in_w, self.in_h = in_w, in_h
        self.out_w, self.out_h = out_w, out_h
        self.fmt_id = ffi.pix_fmt_id(pix_fmt)
        if self.fmt_id < 0:
            raise MediaError(f"unknown pix_fmt {pix_fmt}")

        self._graph = c_void_p(af.avfilter_graph_alloc())
        if not self._graph.value:
            raise MediaError("avfilter_graph_alloc failed")
        try:
            buf = af.avfilter_get_by_name(b"buffer")
            sink = af.avfilter_get_by_name(b"buffersink")
            scale = af.avfilter_get_by_name(b"scale")
            if not (buf and sink and scale):
                raise MediaError("buffer/buffersink/scale filters missing")
            self._src = c_void_p(0)
            args = (
                f"video_size={in_w}x{in_h}:pix_fmt={self.fmt_id}:"
                f"time_base=1/25:pixel_aspect=1/1"
            ).encode()
            ffi.check(
                af.avfilter_graph_create_filter(
                    byref(self._src), c_void_p(buf), b"in", args, None,
                    self._graph),
                "create buffer source",
            )
            self._scale = c_void_p(0)
            sargs = f"w={out_w}:h={out_h}:flags={flags}".encode()
            ffi.check(
                af.avfilter_graph_create_filter(
                    byref(self._scale), c_void_p(scale), b"sc", sargs, None,
                    self._graph),
                "create scale",
            )
            self._sink = c_void_p(0)
            ffi.check(
                af.avfilter_graph_create_filter(
                    byref(self._sink), c_void_p(sink), b"out", None, None,
                    self._graph),
                "create buffersink",
            )
            ffi.check(af.avfilter_link(self._src, 0, self._scale, 0),
                      "link src->scale")
            ffi.check(af.avfilter_link(self._scale, 0, self._sink, 0),
                      "link scale->sink")
            ffi.check(af.avfilter_graph_config(self._graph, None),
                      "graph_config")

            self._frm = ffi.avutil.av_frame_alloc()
            _w_i32(self._frm, OFF["frame_width"], in_w)
            _w_i32(self._frm, OFF["frame_height"], in_h)
            _w_i32(self._frm, OFF["frame_format"], self.fmt_id)
            ffi.check(
                ffi.avutil.av_frame_get_buffer(c_void_p(self._frm), 0),
                "frame_get_buffer",
            )
            self._out = ffi.avutil.av_frame_alloc()
            self._pts = 0
        except Exception:
            af.avfilter_graph_free(byref(self._graph))
            raise

    def scale_gray(self, plane: np.ndarray) -> np.ndarray:
        """(in_h, in_w) float32 -> (out_h, out_w) float32 via swscale."""
        ffi = self.ffi
        h, w = plane.shape
        assert (h, w) == (self.in_h, self.in_w)
        arr = np.ascontiguousarray(plane, np.float32)
        ffi.check(
            ffi.avutil.av_frame_make_writable(c_void_p(self._frm)),
            "frame_make_writable",
        )
        data = _r_ptr(self._frm, OFF["frame_data"])
        ls = _r_i32(self._frm, OFF["frame_linesize"])
        row = w * 4
        if ls == row:
            memmove(data, arr.ctypes.data, row * h)
        else:
            for r_ in range(h):
                memmove(data + r_ * ls, arr.ctypes.data + r_ * row, row)
        _w_i64(self._frm, OFF["frame_pts"], self._pts)
        self._pts += 1
        ffi.check(
            ffi.avfilter.av_buffersrc_add_frame_flags(
                self._src, c_void_p(self._frm), 8),
            "buffersrc_add_frame",
        )
        r = ffi.avfilter.av_buffersink_get_frame(self._sink, c_void_p(self._out))
        if r == AVERROR_EAGAIN:
            raise MediaError("scale produced no frame")
        ffi.check(r, "buffersink_get_frame")
        try:
            out = np.empty((self.out_h, self.out_w), np.float32)
            data = _r_ptr(self._out, OFF["frame_data"])
            ls = _r_i32(self._out, OFF["frame_linesize"])
            row = self.out_w * 4
            if ls == row:
                memmove(out.ctypes.data, data, row * self.out_h)
            else:
                for r_ in range(self.out_h):
                    memmove(out.ctypes.data + r_ * row, data + r_ * ls, row)
            return out
        finally:
            ffi.avutil.av_frame_unref(c_void_p(self._out))

    def close(self):
        if getattr(self, "_graph", None) and self._graph.value:
            if getattr(self, "_frm", None):
                p = c_void_p(self._frm)
                self.ffi.avutil.av_frame_free(byref(p))
                self._frm = None
            if getattr(self, "_out", None):
                p = c_void_p(self._out)
                self.ffi.avutil.av_frame_free(byref(p))
                self._out = None
            self.ffi.avfilter.avfilter_graph_free(byref(self._graph))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def measure_cpu_lut3d_fps(
    cube_path,
    interp: str = "tetrahedral",
    width: int = 3840,
    height: int = 2160,
    frames: int = 8,
    seed: int = 0,
) -> float:
    """Measured frames/sec of FFmpeg's own lut3d on this host's CPU
    (rgb48 path). This is the denominator of the >=5x north star."""
    rng = np.random.default_rng(seed)
    rgb16 = rng.integers(0, 65536, (height, width, 3), dtype=np.uint16)
    with Lut3DOracle(cube_path, interp, "rgb48le", width, height) as oracle:
        oracle.apply_rgb48(rgb16)  # warm
        t0 = time.perf_counter()
        for _ in range(frames):
            oracle.apply_rgb48(rgb16)
        dt = time.perf_counter() - t0
    return frames / dt
