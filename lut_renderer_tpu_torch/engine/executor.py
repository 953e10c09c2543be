"""Stage executor: the pipelined decode -> device render -> encode loop.

Counterpart of lut_renderer_tpu/engine/executor.py:

    [decode thread] --batchQ--> [render_batches on the device] --encQ--> [encode thread]

``render_batches`` is the device loop on its own: host batches of integer
planes in, quantised host planes out. ``run_stage`` wraps it with the
hostio decoder and encoder. On a CUDA device the loop keeps one batch in
flight: batch N+1 is copied in (pinned staging, non-blocking, on a copy
stream) and rendered before the host waits for batch N's copy out, which
runs on its own stream after an event that marks the end of the render.

Not carried over from the JAX executor: geometry bucketing (CUDA kernels
take runtime shapes, so there is no per-shape compile to avoid), the
gather fallback on a non-TPU platform and the device mesh (the device is
explicit), and the per-LUT precision gate (the tier log names the tier
``ops.render.lut_tier`` runs: exact, or the requested coarse2 tier).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..hostio.decode import VideoDecoder
from ..hostio.encode import VideoEncoder
from ..models import VideoInfo
from ..plan.policy import RenderSpec

from ..device import DeviceLike, resolve_device
from ..ops.render import lut_tier, make_render_fn
from .config import (
    derive_encoder_settings,
    derive_render_config,
    effective_output_pix_fmt,
    output_fps,
    parse_resolution,
)
from .scheduler import FrameScheduler

ProgressCb = Callable[[int], None]
LogCb = Callable[[str], None]
# (y, u, v, count): stacked planes of one batch and how many frames are real
HostBatch = Tuple[np.ndarray, np.ndarray, np.ndarray, int]


@dataclass
class StageStats:
    frames_in: int = 0
    frames_out: int = 0
    wall_s: float = 0.0
    decode_s: float = 0.0
    render_s: float = 0.0
    encode_s: float = 0.0
    batches: int = 0

    def summary(self) -> str:
        def rate(n, t):
            return f"{n / t:.1f} fps" if t > 0 else "n/a"

        return (
            f"{self.frames_out} frames in {self.wall_s:.2f}s "
            f"({rate(self.frames_out, self.wall_s)} overall; "
            f"decode {rate(self.frames_in, self.decode_s)}, "
            f"render {rate(self.frames_out, self.render_s)}, "
            f"encode {rate(self.frames_out, self.encode_s)})"
        )


@dataclass
class StageResult:
    ok: bool
    canceled: bool = False
    error: str = ""
    stats: StageStats = field(default_factory=StageStats)


def _pick_batch_size(width: int, height: int) -> int:
    # target ~16 Mpix per device step; clamp to [1, 16]
    per = max(1, width * height)
    return int(max(1, min(16, round(16_000_000 / per))))


def render_batches(batches: Iterable[HostBatch], render_fn,
                   device: torch.device,
                   stats: Optional[StageStats] = None) -> Iterator[HostBatch]:
    """Run `render_fn` over host batches on `device`, yielding numpy
    outputs in order. On CUDA one batch stays in flight; the yielded
    arrays live in pinned buffers and stay valid while referenced."""
    stats = stats if stats is not None else StageStats()
    if device.type != "cuda":
        for y, u, v, count in batches:
            t0 = time.perf_counter()
            outs = render_fn(*(torch.from_numpy(a) for a in (y, u, v)))
            res = tuple(o.numpy() for o in outs)
            stats.render_s += time.perf_counter() - t0
            stats.batches += 1
            yield (*res, count)
        return

    compute = torch.cuda.current_stream(device)
    h2d = torch.cuda.Stream(device)
    d2h = torch.cuda.Stream(device)
    in_flight = None  # (pinned outputs, done event, count)
    for y, u, v, count in batches:
        t0 = time.perf_counter()
        staged = [torch.from_numpy(a).pin_memory() for a in (y, u, v)]
        with torch.cuda.stream(h2d):
            planes = [s.to(device, non_blocking=True) for s in staged]
        compute.wait_stream(h2d)
        for p in planes:
            p.record_stream(compute)
        outs = render_fn(*planes)
        rendered = torch.cuda.Event()
        rendered.record(compute)
        host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                for o in outs]
        with torch.cuda.stream(d2h):
            d2h.wait_event(rendered)
            for h, o in zip(host, outs):
                o.record_stream(d2h)
                h.copy_(o, non_blocking=True)
            done = torch.cuda.Event()
            done.record(d2h)
        prev, in_flight = in_flight, (host, done, count)
        if prev is not None:
            prev[1].synchronize()
            stats.render_s += time.perf_counter() - t0
            stats.batches += 1
            yield (*(h.numpy() for h in prev[0]), prev[2])
        else:
            stats.render_s += time.perf_counter() - t0
    if in_flight is not None:
        t0 = time.perf_counter()
        in_flight[1].synchronize()
        stats.render_s += time.perf_counter() - t0
        stats.batches += 1
        yield (*(h.numpy() for h in in_flight[0]), in_flight[2])


def run_stage(
    spec: RenderSpec,
    source_info: Optional[VideoInfo],
    lut,
    progress_cb: Optional[ProgressCb] = None,
    log_cb: Optional[LogCb] = None,
    cancel: Optional[threading.Event] = None,
    batch_size: Optional[int] = None,
    device: DeviceLike = "cuda",
    lut_strategy: str = "mxu",
    profile_dir: Optional[str] = None,
) -> StageResult:
    """Render one stage file to file. `lut` is a LutTable, a Coarse2Table,
    the JAX package's PreparedLut, a parsed Lut3D, or None. An unusable `device`
    raises; media and render failures return a failed StageResult.
    `lut_strategy` is accepted for parity with the JAX executor; both
    values run the same kernels."""
    del lut_strategy
    dev = resolve_device(device)
    log = log_cb or (lambda m: None)
    progress = progress_cb or (lambda p: None)
    cancel = cancel or threading.Event()
    stats = StageStats()
    t_start = time.perf_counter()

    try:
        dec = VideoDecoder(spec.source)
    except Exception as exc:
        return StageResult(ok=False, error=f"decode open failed: {exc}")

    try:
        w, h = dec.width, dec.height
        if w % 2 or h % 2:
            dec.close()
            return StageResult(
                ok=False,
                error=f"odd frame dimensions {w}x{h} unsupported for 4:2:0",
            )
        eff_pix = effective_output_pix_fmt(spec, source_info)
        if eff_pix != spec.pix_fmt:
            spec = dataclasses.replace(spec, pix_fmt=eff_pix)
            log(f"engine: output pix_fmt negotiated to {eff_pix} "
                f"({spec.video_codec} supported formats)")
        cfg = derive_render_config(spec, source_info)
        out_w, out_h = parse_resolution(spec.resolution) or (w, h)
        enc_settings = derive_encoder_settings(spec, source_info, out_w, out_h)
        fps = output_fps(spec, source_info)
        if cfg.resize == (w, h):
            # the task factory echoes the source size into `resolution`;
            # a 1:1 resample is the identity, so the no-op is dropped
            cfg = dataclasses.replace(cfg, resize=None)
        if cfg.resize is not None:
            dec.close()
            return StageResult(
                ok=False,
                error=f"resize to {cfg.resize[0]}x{cfg.resize[1]} is not "
                      f"ported to the PyTorch engine yet")
        bsz = batch_size or _pick_batch_size(w, h)
        log(
            f"engine: {w}x{h} -> {out_w}x{out_h} @{float(fps):.3f}fps, "
            f"batch={bsz}, in {cfg.in_depth}bit/{cfg.in_subsampling} "
            f"-> out {cfg.out_depth}bit/{cfg.out_subsampling}, "
            f"interp={cfg.interp}, dither={cfg.dither}, "
            f"matrix {cfg.matrix_in}->{cfg.matrix_out}, device={dev}"
        )
        if lut is not None and cfg.apply_lut:
            log(f"engine: LUT kernel precision="
                f"{lut_tier(cfg.lut_precision, lut.size)}")

        audio_from = (
            Path(spec.source)
            if (source_info and source_info.audio_codec and spec.audio_codec)
            else None
        )
        audio_mode = spec.audio_codec or "copy"

        def _as_int(v):
            try:
                return int(float(v)) if v else None
            except (TypeError, ValueError):
                return None

        try:
            enc = VideoEncoder(spec.output, enc_settings, audio_from=audio_from,
                               audio_mode=audio_mode,
                               audio_bitrate=spec.audio_bitrate,
                               audio_sample_rate=_as_int(spec.sample_rate),
                               audio_channels=_as_int(spec.channels))
        except Exception as exc:
            dec.close()
            return StageResult(ok=False, error=f"encoder open failed: {exc}")

        render_fn = make_render_fn(lut, cfg, dev)
        sched = FrameScheduler(spec.fps_mode, fps)

        total_est = None
        if source_info:
            if spec.fps_mode == "cfr" and source_info.duration:
                total_est = int(source_info.duration * float(fps))
            elif source_info.nb_frames:
                total_est = source_info.nb_frames
            elif source_info.duration and source_info.fps:
                total_est = int(source_info.duration * source_info.fps)

        batch_q: "queue.Queue" = queue.Queue(maxsize=2)
        enc_q: "queue.Queue" = queue.Queue(maxsize=2)
        enc_error: list = []

        def decode_loop():
            t0 = time.perf_counter()
            ys, us, vs = [], [], []
            try:
                for frame in sched.schedule(iter(dec)):
                    if cancel.is_set():
                        break
                    stats.frames_in += 1
                    ys.append(frame.y)
                    us.append(frame.u)
                    vs.append(frame.v)
                    if len(ys) == bsz:
                        batch_q.put(("batch", np.stack(ys), np.stack(us),
                                     np.stack(vs), bsz))
                        ys, us, vs = [], [], []
                if ys and not cancel.is_set():
                    count = len(ys)
                    while len(ys) < bsz:  # pad to the batch shape
                        ys.append(ys[-1]); us.append(us[-1]); vs.append(vs[-1])
                    batch_q.put(("batch", np.stack(ys), np.stack(us),
                                 np.stack(vs), count))
                batch_q.put(("eof", None, None, None, 0))
            except Exception as exc:  # propagated by the render loop
                batch_q.put(("error", exc, None, None, 0))
            finally:
                stats.decode_s += time.perf_counter() - t0

        host_ed = cfg.dither == "error_diffusion_host"
        if host_ed:
            from ..native_ext import error_diffusion_quantize

            def _finish(plane):
                out = error_diffusion_quantize(plane, cfg.out_depth)
                if out is None:  # native lib vanished mid-run: plain rounding
                    maxv = (1 << cfg.out_depth) - 1
                    out = np.clip(np.floor(plane + 0.5), 0, maxv).astype(
                        np.uint8 if cfg.out_depth <= 8 else np.uint16
                    )
                return out

        def encode_loop():
            while True:
                item = enc_q.get()
                if item is None:
                    return
                yq, uq, vq, count = item
                t0 = time.perf_counter()
                try:
                    for i in range(count):
                        if host_ed:
                            enc.write(_finish(yq[i]), _finish(uq[i]),
                                      _finish(vq[i]))
                        else:
                            enc.write(yq[i], uq[i], vq[i])
                        stats.frames_out += 1
                        if total_est:
                            progress(min(99, int(100 * stats.frames_out
                                                 / total_est)))
                except Exception as exc:
                    enc_error.append(exc)
                    return
                finally:
                    stats.encode_s += time.perf_counter() - t0

        dec_thread = threading.Thread(target=decode_loop, daemon=True)
        enc_thread = threading.Thread(target=encode_loop, daemon=True)
        dec_thread.start()
        enc_thread.start()

        error: Optional[str] = None

        def emit(item) -> Optional[str]:
            # bounded put that won't deadlock if the encoder died
            while True:
                if enc_error:
                    return f"encode failed: {enc_error[0]}"
                try:
                    enc_q.put(item, timeout=1.0)
                    return None
                except queue.Full:
                    continue

        def host_batches():
            nonlocal error
            while not cancel.is_set():
                kind, a, b, c, count = batch_q.get()
                if kind == "error":
                    error = f"decode failed: {a}"
                    return
                if kind == "eof":
                    return
                yield a, b, c, count

        prof = None
        if profile_dir:
            # device-level trace of the render loop
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            log(f"engine: torch profiler trace -> {profile_dir}")

        try:
            for out in render_batches(host_batches(), render_fn, dev, stats):
                if cancel.is_set():
                    break
                failed = emit(out)
                if failed:
                    error = failed
                    break
        except Exception as exc:
            error = f"render failed: {exc}"
        finally:
            if prof is not None:
                prof.stop()
                Path(profile_dir).mkdir(parents=True, exist_ok=True)
                prof.export_chrome_trace(
                    str(Path(profile_dir) / "render_trace.json"))
            cancel_set = cancel.is_set()
            if cancel_set or error:
                cancel.set()
            # unblock and retire the decode thread (it may be blocked on put)
            while dec_thread.is_alive():
                try:
                    while True:
                        batch_q.get_nowait()
                except queue.Empty:
                    pass
                dec_thread.join(timeout=0.5)
            # retire the encode thread; only drop queued batches on failure
            while True:
                try:
                    enc_q.put(None, timeout=1.0)
                    break
                except queue.Full:
                    if not enc_thread.is_alive():
                        break
                    if cancel_set or error:
                        try:
                            enc_q.get_nowait()
                        except queue.Empty:
                            pass
            enc_thread.join(timeout=60)
            dec.close()

        if enc_error and not error:
            error = f"encode failed: {enc_error[0]}"
        if error or cancel_set:
            try:
                enc._abort()
            except Exception:
                pass
            stats.wall_s = time.perf_counter() - t_start
            if cancel_set and not error:
                return StageResult(ok=False, canceled=True, stats=stats)
            return StageResult(ok=False, error=error or "canceled",
                               stats=stats)

        try:
            enc.close()
        except Exception as exc:
            stats.wall_s = time.perf_counter() - t_start
            return StageResult(ok=False, error=f"finalize failed: {exc}",
                               stats=stats)

        stats.wall_s = time.perf_counter() - t_start
        progress(100)
        return StageResult(ok=True, stats=stats)
    except Exception as exc:
        stats.wall_s = time.perf_counter() - t_start
        try:
            dec.close()
        except Exception:
            pass
        return StageResult(ok=False, error=str(exc), stats=stats)
