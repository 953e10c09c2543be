"""Audio handling: stream copy (default) and AAC re-encode.

The reference's default is `-c:a aac` re-encode with optional bitrate /
sample-rate / channel overrides (src/lut_renderer/ffmpeg.py:400-408), with
`copy` used by the pro master (ffmpeg.py:420). Here:

  * copy: packet-level remux (implemented in encode.VideoEncoder);
  * transcode: decode -> abuffer/aformat/asetnsamples filter graph ->
    encode. The filter graph performs sample-format/rate conversion and
    re-frames to the encoder's frame size (1024 for AAC), so ANY decodable
    audio source transcodes; unexpected failures fall back to copy
    (graceful degradation, matching the reference's no-preflight
    philosophy).

Frames pass decoder -> graph -> encoder without manual reconstruction so no
fragile AVFrame audio-field offsets are needed.
"""

from __future__ import annotations

from ctypes import byref, c_void_p
from pathlib import Path
from typing import List, Optional, Tuple

from .ffi import (
    AVERROR_EAGAIN,
    AVERROR_EOF,
    AVMEDIA_TYPE_AUDIO,
    OFF,
    Rational,
    _r_i32,
    _r_i64,
    _r_ptr,
    _r_rational,
    _w_i64,
    get_ffi,
)


def _encoder_sample_fmt(ffi, enc, decoded_fmt_name: str) -> str:
    """The ffmpeg CLI's automatic sample-format negotiation: keep the decoded
    format when the encoder supports it, else take the encoder's preferred
    (first) format — e.g. aac -> fltp, alac -> s32p from s16, ac3 -> fltp.

    Uses avcodec_get_supported_config with AV_CODEC_CONFIG_SAMPLE_FORMAT (3),
    the lavc 62 API also used for pixel formats in encode.encoder_pix_fmts.
    """
    import ctypes as ct

    fn = ffi.avcodec.avcodec_get_supported_config
    fn.argtypes = [c_void_p, c_void_p, ct.c_int, ct.c_uint,
                   ct.POINTER(c_void_p), ct.POINTER(ct.c_int)]
    fn.restype = ct.c_int
    out = c_void_p(0)
    count = ct.c_int(0)
    if fn(None, enc, 3, 0, byref(out), byref(count)) < 0 or not out.value:
        return decoded_fmt_name
    arr = ct.cast(out.value, ct.POINTER(ct.c_int))
    ffi.avutil.av_get_sample_fmt_name.argtypes = [ct.c_int]
    ffi.avutil.av_get_sample_fmt_name.restype = ct.c_char_p
    names = []
    for i in range(count.value):
        nm = ffi.avutil.av_get_sample_fmt_name(arr[i])
        if nm:
            names.append(nm.decode())
    if decoded_fmt_name in names or not names:
        return decoded_fmt_name
    return names[0]


def _encoder_sample_rates(ffi, enc) -> List[int]:
    """Supported sample rates of an encoder (AV_CODEC_CONFIG_SAMPLE_RATE=2);
    empty list means unrestricted."""
    import ctypes as ct

    fn = ffi.avcodec.avcodec_get_supported_config
    fn.argtypes = [c_void_p, c_void_p, ct.c_int, ct.c_uint,
                   ct.POINTER(c_void_p), ct.POINTER(ct.c_int)]
    fn.restype = ct.c_int
    out = c_void_p(0)
    count = ct.c_int(0)
    if fn(None, enc, 2, 0, byref(out), byref(count)) < 0 or not out.value:
        return []
    arr = ct.cast(out.value, ct.POINTER(ct.c_int))
    return [arr[i] for i in range(count.value) if arr[i] > 0]


# ffmpeg's av_channel_layout_default names for 1..8 channels (what `-ac N`
# resolves to); counts outside the table keep the source layout and the
# policy preflight emits a degradation note (plan/policy.py).
_CHANNEL_LAYOUTS = {1: "mono", 2: "stereo", 3: "2.1", 4: "4.0",
                    5: "5.0", 6: "5.1", 7: "6.1", 8: "7.1"}


def transcode_audio_packets(
    source: Path,
    codec: str = "aac",
    bitrate_bits: Optional[int] = None,
    sample_rate: Optional[int] = None,
    channels: Optional[int] = None,
) -> Optional[Tuple[int, List[Tuple[bytes, int, int, int, int]], Tuple[int, int]]]:
    """Decode + re-encode the source's audio stream.

    `sample_rate` / `channels` are the reference's `-ar` / `-ac` overrides
    (ffmpeg.py:400-408): the filter graph resamples / remixes to the target
    before encoding. A requested (or source) rate outside the encoder's
    supported set snaps to the nearest supported rate, like the ffmpeg CLI
    (e.g. opus: 44100 -> 48000).

    Returns (encoder_ctx_for_params, packets, time_base) on success where
    packets are (data, pts, dts, duration, flags) in `time_base` units, or
    None when the source has no audio or the shapes are not directly
    compatible (caller falls back to copy). The returned encoder context
    remains allocated so the caller can copy its parameters; caller frees it
    with free_audio_ctx().
    """
    import ctypes as ct

    ffi = get_ffi()
    f = ffi.avformat
    ac = ffi.avcodec

    ictx = c_void_p(0)
    if f.avformat_open_input(byref(ictx), str(source).encode(), None, None) < 0:
        return None
    enc_ctx = 0
    try:
        if f.avformat_find_stream_info(ictx, None) < 0:
            return None
        decp = c_void_p(0)
        aidx = f.av_find_best_stream(ictx, AVMEDIA_TYPE_AUDIO, -1, -1, byref(decp), 0)
        if aidx < 0:
            return None
        streams = _r_ptr(ictx.value, OFF["fmt_streams"])
        ast = _r_ptr(streams, 8 * aidx)
        apar = _r_ptr(ast, OFF["st_codecpar"])
        src_tb = _r_rational(ast, OFF["st_time_base"])

        dctx = ac.avcodec_alloc_context3(decp)
        try:
            if ac.avcodec_parameters_to_context(c_void_p(dctx), c_void_p(apar)) < 0:
                return None
            if ac.avcodec_open2(c_void_p(dctx), decp, None) < 0:
                return None
            src_rate = ffi.opt_get_int(dctx, "ar") or 48000

            # declare clone once
            ffi.avutil.av_frame_clone.argtypes = [c_void_p]
            ffi.avutil.av_frame_clone.restype = c_void_p

            # ---- phase 1: decode every audio frame (cloned refs) ----------
            pkt = ac.av_packet_alloc()
            frm = ffi.avutil.av_frame_alloc()
            frames: List[int] = []
            try:
                eof = False
                while not eof:
                    rr = f.av_read_frame(ictx, c_void_p(pkt))
                    if rr < 0:
                        ac.avcodec_send_packet(c_void_p(dctx), None)
                        eof = True
                    elif _r_i32(pkt, OFF["pkt_stream_index"]) != aidx:
                        ac.av_packet_unref(c_void_p(pkt))
                        continue
                    else:
                        ac.avcodec_send_packet(c_void_p(dctx), c_void_p(pkt))
                        ac.av_packet_unref(c_void_p(pkt))
                    while True:
                        r = ac.avcodec_receive_frame(c_void_p(dctx), c_void_p(frm))
                        if r in (AVERROR_EAGAIN, AVERROR_EOF):
                            break
                        if r < 0:
                            raise RuntimeError("audio decode failed")
                        clone = ffi.avutil.av_frame_clone(c_void_p(frm))
                        if clone:
                            frames.append(clone)
                        ffi.avutil.av_frame_unref(c_void_p(frm))
            except Exception:
                for fr in frames:
                    fp = c_void_p(fr)
                    ffi.avutil.av_frame_free(byref(fp))
                p = c_void_p(pkt); ac.av_packet_free(byref(p))
                fp = c_void_p(frm); ffi.avutil.av_frame_free(byref(fp))
                return None

            if not frames:
                p = c_void_p(pkt); ac.av_packet_free(byref(p))
                fp = c_void_p(frm); ffi.avutil.av_frame_free(byref(fp))
                return None

            # ---- phase 2: audio filter graph (convert + reframe) ----------
            ffi.avutil.av_get_sample_fmt_name.argtypes = [ct.c_int]
            ffi.avutil.av_get_sample_fmt_name.restype = ct.c_char_p
            dec_fmt = _r_i32(frames[0], OFF["frame_format"])
            fmt_name = ffi.avutil.av_get_sample_fmt_name(dec_fmt)
            fmt_name = fmt_name.decode() if fmt_name else "s16"
            buf = c_void_p(0)
            layout = "stereo"
            if ffi.avutil.av_opt_get(c_void_p(dctx), b"ch_layout", 0, byref(buf)) >= 0 and buf.value:
                layout = ct.string_at(buf.value).decode()
                ffi.avutil.av_free(buf)
            if "channel" in layout:
                # unordered layouts ("2 channels", e.g. from WAV) need a named
                # layout for the AAC encoder
                try:
                    nch = int(layout.split()[0])
                except ValueError:
                    nch = 2
                layout = {1: "mono", 2: "stereo", 6: "5.1", 8: "7.1"}.get(nch, "stereo")

            enc = ac.avcodec_find_encoder_by_name(codec.encode())
            ok = bool(enc)
            enc_ctx = ac.avcodec_alloc_context3(c_void_p(enc)) if ok else 0
            target_fmt = (
                _encoder_sample_fmt(ffi, c_void_p(enc), fmt_name) if ok
                else fmt_name
            )
            out_rate = int(sample_rate) if sample_rate else src_rate
            if ok:
                rates = _encoder_sample_rates(ffi, c_void_p(enc))
                if rates and out_rate not in rates:
                    out_rate = min(rates, key=lambda r: (abs(r - out_rate), -r))
            out_layout = layout
            if channels:
                out_layout = _CHANNEL_LAYOUTS.get(int(channels), layout)
            if ok:
                ffi.opt_set(enc_ctx, "ar", str(out_rate))
                ffi.opt_set(enc_ctx, "ch_layout", out_layout)
                if bitrate_bits:
                    ffi.opt_set(enc_ctx, "b", str(bitrate_bits))
                ffi.opt_set(enc_ctx, "time_base", f"1/{out_rate}")
                # the `-strict -2` gate: lets FFmpeg-"experimental" encoders
                # (native opus/vorbis) open; solid codecs are unaffected
                ffi.opt_set(enc_ctx, "strict", "experimental")
                # sample_fmt has no AVOption; offset 348 verified at runtime
                # (lavc 62: aac opens with fltp and reports frame_size 1024)
                from .ffi import _w_i32 as _w32

                fmt_id = ffi.avutil.av_get_sample_fmt(target_fmt.encode()) if hasattr(ffi.avutil, "av_get_sample_fmt") else 8
                ffi.avutil.av_get_sample_fmt.argtypes = [ct.c_char_p]
                ffi.avutil.av_get_sample_fmt.restype = ct.c_int
                fmt_id = ffi.avutil.av_get_sample_fmt(target_fmt.encode())
                _w32(enc_ctx, 348, fmt_id if fmt_id >= 0 else 8)
                ok = ac.avcodec_open2(c_void_p(enc_ctx), c_void_p(enc), None) >= 0
            enc_frame_size = (ffi.opt_get_int(enc_ctx, "frame_size") or 1024) if ok else 0

            graph = src_ctx = sink_ctx = None
            if ok:
                af = ffi.avfilter
                af.avfilter_graph_alloc.restype = c_void_p
                af.avfilter_get_by_name.restype = c_void_p
                af.avfilter_get_by_name.argtypes = [ct.c_char_p]
                af.avfilter_graph_create_filter.argtypes = [
                    ct.POINTER(c_void_p), c_void_p, ct.c_char_p, ct.c_char_p,
                    c_void_p, c_void_p,
                ]
                af.avfilter_graph_create_filter.restype = ct.c_int
                af.avfilter_link.argtypes = [c_void_p, ct.c_int, c_void_p, ct.c_int]
                af.avfilter_link.restype = ct.c_int
                af.avfilter_graph_config.argtypes = [c_void_p, c_void_p]
                af.avfilter_graph_config.restype = ct.c_int
                af.av_buffersrc_add_frame_flags.argtypes = [c_void_p, c_void_p, ct.c_int]
                af.av_buffersrc_add_frame_flags.restype = ct.c_int
                af.av_buffersink_get_frame.argtypes = [c_void_p, c_void_p]
                af.av_buffersink_get_frame.restype = ct.c_int
                af.avfilter_graph_free.argtypes = [ct.POINTER(c_void_p)]

                graph = c_void_p(af.avfilter_graph_alloc())
                src_ctx = c_void_p(0)
                sink_ctx = c_void_p(0)
                fmt_ctx_n = c_void_p(0)
                setn_ctx = c_void_p(0)
                args = (
                    f"sample_rate={src_rate}:sample_fmt={fmt_name}:"
                    f"channel_layout={layout}:time_base=1/{src_rate}"
                ).encode()
                ok = (
                    af.avfilter_graph_create_filter(
                        byref(src_ctx), c_void_p(af.avfilter_get_by_name(b"abuffer")),
                        b"in", args, None, graph) >= 0
                    and af.avfilter_graph_create_filter(
                        byref(fmt_ctx_n), c_void_p(af.avfilter_get_by_name(b"aformat")),
                        b"fmt",
                        (f"sample_fmts={target_fmt}:sample_rates={out_rate}:"
                         f"channel_layouts={out_layout}").encode(),
                        None, graph) >= 0
                    and af.avfilter_graph_create_filter(
                        byref(setn_ctx), c_void_p(af.avfilter_get_by_name(b"asetnsamples")),
                        b"setn", f"n={enc_frame_size}:p=0".encode(), None, graph) >= 0
                    and af.avfilter_graph_create_filter(
                        byref(sink_ctx), c_void_p(af.avfilter_get_by_name(b"abuffersink")),
                        b"out", None, None, graph) >= 0
                    and af.avfilter_link(src_ctx, 0, fmt_ctx_n, 0) >= 0
                    and af.avfilter_link(fmt_ctx_n, 0, setn_ctx, 0) >= 0
                    and af.avfilter_link(setn_ctx, 0, sink_ctx, 0) >= 0
                    and af.avfilter_graph_config(graph, None) >= 0
                )

            # ---- phase 3: frames -> graph -> encoder ----------------------
            out_pkts: List[Tuple[bytes, int, int, int, int]] = []

            def drain_encoder():
                while True:
                    r = ac.avcodec_receive_packet(c_void_p(enc_ctx), c_void_p(pkt))
                    if r in (AVERROR_EAGAIN, AVERROR_EOF):
                        return
                    if r < 0:
                        raise RuntimeError("audio receive_packet failed")
                    size = _r_i32(pkt, OFF["pkt_size"])
                    data = ct.string_at(_r_ptr(pkt, OFF["pkt_data"]), size)
                    out_pkts.append((
                        data,
                        _r_i64(pkt, OFF["pkt_pts"]),
                        _r_i64(pkt, OFF["pkt_dts"]),
                        _r_i64(pkt, OFF["pkt_duration"]),
                        _r_i32(pkt, OFF["pkt_flags"]),
                    ))
                    ac.av_packet_unref(c_void_p(pkt))

            try:
                if ok:
                    af = ffi.avfilter
                    next_pts = 0
                    filt = ffi.avutil.av_frame_alloc()

                    def pull_and_encode():
                        nonlocal next_pts, ok
                        while True:
                            r = af.av_buffersink_get_frame(sink_ctx, c_void_p(filt))
                            if r in (AVERROR_EAGAIN, AVERROR_EOF):
                                return
                            if r < 0:
                                ok = False
                                return
                            nbs = _r_i32(filt, OFF["frame_nb_samples"])
                            _w_i64(filt, OFF["frame_pts"], next_pts)
                            next_pts += nbs
                            if ac.avcodec_send_frame(c_void_p(enc_ctx), c_void_p(filt)) < 0:
                                ok = False
                                return
                            drain_encoder()
                            ffi.avutil.av_frame_unref(c_void_p(filt))

                    for fr in frames:
                        if not ok:
                            break
                        if af.av_buffersrc_add_frame_flags(src_ctx, c_void_p(fr), 8) < 0:
                            ok = False
                            break
                        pull_and_encode()
                    if ok:
                        af.av_buffersrc_add_frame_flags(src_ctx, None, 0)
                        pull_and_encode()
                        ac.avcodec_send_frame(c_void_p(enc_ctx), None)
                        drain_encoder()
                    fp = c_void_p(filt)
                    ffi.avutil.av_frame_free(byref(fp))
            except Exception:
                ok = False
            finally:
                if graph is not None and graph.value:
                    ffi.avfilter.avfilter_graph_free(byref(graph))
                for fr in frames:
                    fp = c_void_p(fr)
                    ffi.avutil.av_frame_free(byref(fp))
                p = c_void_p(pkt)
                ac.av_packet_free(byref(p))
                fp = c_void_p(frm)
                ffi.avutil.av_frame_free(byref(fp))

            if not ok or not out_pkts:
                return None
            result_ctx = enc_ctx
            enc_ctx = 0  # ownership passes to caller
            return result_ctx, out_pkts, (1, out_rate)
        finally:
            p = c_void_p(dctx)
            ac.avcodec_free_context(byref(p))
    finally:
        if enc_ctx:
            p = c_void_p(enc_ctx)
            ffi.avcodec.avcodec_free_context(byref(p))
        f.avformat_close_input(byref(ictx))


def free_audio_ctx(ctx: int) -> None:
    ffi = get_ffi()
    p = c_void_p(ctx)
    ffi.avcodec.avcodec_free_context(byref(p))
