"""Stage executor: the pipelined decode -> device render -> encode loop.

Counterpart of lut_renderer_tpu/engine/executor.py:

    [decode thread] --batchQ--> [render_batches on the device] --encQ--> [encode thread]

``render_batches`` is the device loop on its own: host batches of integer
planes in, quantised host planes out. ``run_stage`` wraps it with the
hostio decoder and encoder. A staging thread takes the host batches and
copies each in, one batch ahead of the loop; the loop keeps one batch in
flight: batch N+1 is rendered before the host waits for batch N's copy
out. On a CUDA device the copy in goes pageable -> pinned into a slot of
the device's pinned ring (``PinnedRing``, kept across calls), then
non-blocking on a copy stream, and the copy out runs on its own stream
after an event that marks the end of the render; on the CPU, where the
tests run it, the same loop hands the host arrays over as they are.

With more than one card and ``device="cuda"`` (no index), the frame batch
is split across the cards as the JAX executor shards it over its mesh
(parallel.sharding); ``"cuda:N"`` pins one card. The batch then rounds up
to a multiple of the card count, and the split stages through the first
card: its copy engine takes every batch in and out. The split's own spans
(``sharding.call`` and its ``sharding.put``, ``sharding.chunk`` a card and
``sharding.gather``) run inside ``executor.render``; its ``SplitStats``
(calls, frames a card, bytes copied between cards) shows in
``StageStats.summary()``.

Not carried over from the JAX executor: geometry bucketing (CUDA kernels
take runtime shapes, so there is no per-shape compile to avoid), the
gather fallback on a non-TPU platform (the device is explicit), and the
per-LUT precision gate (the tier log names the tier ``ops.render.lut_tier``
runs: exact, or the requested coarse2 tier).
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools
import queue
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import (Callable, Dict, Iterable, Iterator, List, NamedTuple,
                    Optional, Tuple)

import numpy as np
import torch

from ..hostio.decode import VideoDecoder
from ..hostio.encode import VideoEncoder
from ..models import VideoInfo
from ..plan.policy import RenderSpec

from ..device import DeviceLike, resolve_device
from ..ops import fused420
from ..ops._build import load_library
from ..ops.render import lut_tier, make_render_fn
from ..parallel import SplitStats, default_mesh, make_sharded_render_fn
from ..spans import begin as begin_spans
from ..spans import span, write_jsonl as write_spans
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
    """A stage's counters. The seconds are sums of its spans
    (``spans.span``): the decode loop's and each encoded batch's, and per
    batch of the device loop: take (the next host batch), stage (the
    staging thread's ``executor.pin``: pageable -> pinned and the copy in
    on CUDA), render (the render call), out (the pinned outputs and the
    copy out on CUDA) and wait (for the previous batch's copy out on
    CUDA; the CPU's out and wait do nothing). `staged_ready` counts the
    batches already staged when the loop asked for them. `ring_staged`
    counts the batches staged through a slot of the pinned ring (CUDA),
    `ring_allocs` the slots the stage allocated (none where it found the
    device's ring warm) and `ring_waits` the times the staging thread
    waited for a slot's last copy in. `split` is the
    split render function's counters where the stage splits its batch over
    several devices. `launches_by_interp` is kernel B's launches by
    interpolation while the stage's device loop ran
    (``ops.fused420.launches_by_interp``, a process-wide counter: a stage
    that runs beside another counts the other's launches too)."""

    frames_in: int = 0
    frames_out: int = 0
    wall_s: float = 0.0
    decode_s: float = 0.0
    take_s: float = 0.0
    stage_s: float = 0.0
    render_s: float = 0.0
    out_s: float = 0.0
    wait_s: float = 0.0
    encode_s: float = 0.0
    batches: int = 0
    staged_ready: int = 0
    ring_staged: int = 0
    ring_allocs: int = 0
    ring_waits: int = 0
    split: Optional[SplitStats] = None
    launches_by_interp: Dict[str, int] = field(default_factory=dict)

    def summary(self) -> str:
        def rate(n, t):
            return f"{n / t:.1f} fps" if t > 0 else "n/a"

        loop_s = self.stage_s + self.render_s + self.out_s + self.wait_s
        steps = ", ".join(
            f"{k} {getattr(self, k + '_s') / self.batches * 1e3:.2f}"
            for k in ("take", "stage", "render", "out", "wait")
        ) if self.batches else "n/a"
        split = f"; {self.split.summary()}" if self.split else ""
        kernel_b = ", ".join(f"{k} {n}" for k, n in
                             sorted(self.launches_by_interp.items()) if n)
        if kernel_b:
            split += f"; kernel B launches by interp: {kernel_b}"
        if self.ring_staged or self.ring_allocs:
            split += (f"; pinned ring: {self.ring_staged} staged, "
                      f"{self.ring_allocs} slots allocated, "
                      f"{self.ring_waits} waits")
        return (
            f"{self.frames_out} frames in {self.wall_s:.2f}s "
            f"({rate(self.frames_out, self.wall_s)} overall; "
            f"decode {rate(self.frames_in, self.decode_s)}, "
            f"device loop {rate(self.frames_out, loop_s)}, "
            f"encode {rate(self.frames_out, self.encode_s)}); "
            f"staged ahead {self.staged_ready}/{self.batches}; "
            f"ms a batch: {steps}{split}"
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


def stage_devices(device: DeviceLike = "cuda",
                  use_mesh: Optional[bool] = None) -> List[torch.device]:
    """The devices a stage renders on: `device`, or with `use_mesh` every
    visible card (parallel.default_mesh). None splits when `device` is
    plain ``"cuda"`` (no index) and torch sees more than one card."""
    dev = resolve_device(device)
    if use_mesh is None:
        use_mesh = (dev.type == "cuda" and torch.device(device).index is None
                    and torch.cuda.device_count() > 1)
    return default_mesh() if use_mesh else [dev]


# the staging thread's hand-off: `_END`, or a `_Failed` the loop raises
_END = object()
# seconds between a blocked hand-off's looks at its stop flag
_HANDOFF_POLL_S = 0.05


class _Failed(NamedTuple):
    exc: BaseException


def _put(handoff: "queue.Queue", item, stop: threading.Event) -> bool:
    """Put `item` once there is room; False if `stop` is set first."""
    while not stop.is_set():
        try:
            handoff.put(item, timeout=_HANDOFF_POLL_S)
            return True
        except queue.Full:
            continue
    return False


def _stage_loop(source: Iterator, stage, run, stats: StageStats,
                handoff: "queue.Queue", stop: threading.Event,
                close: Optional[Callable[[], None]]) -> None:
    """The staging thread: take each item of `source` (``executor.take``),
    stage it (``executor.pin``) and hand it over, until the source ends or
    fails or `stop` is set; then `close`. It keeps nothing it handed
    over."""
    try:
        for i in itertools.count():
            with span("executor.take", run, batch=i) as sp:
                item = next(source, _END)
            stats.take_s += sp.seconds
            if item is _END or stop.is_set():
                break
            with span("executor.pin", run, batch=i) as sp:
                staged = stage(item, sp)
            stats.stage_s += sp.seconds
            del item
            if not _put(handoff, staged, stop):
                return
            del staged
    except BaseException as exc:  # raised on the loop's thread, in order
        _put(handoff, _Failed(exc), stop)
        return
    finally:
        if close is not None:
            close()
    _put(handoff, _END, stop)


def stage_ahead(source: Iterable, stage, run=None,
                stats: Optional[StageStats] = None,
                close: Optional[Callable[[], None]] = None
                ) -> Iterator[Tuple[object, bool]]:
    """``(stage(item, sp), ready)`` for each item of `source`, in order:
    `stage` runs on a thread of its own, one item ahead of the caller (at
    most one staged item waits while the next is staged), and may set
    attributes of its ``executor.pin`` span `sp`; `ready` is true when the
    staged item was already waiting as the caller asked for it. An
    exception of `source` or `stage` is raised here, after the items
    before it. Closing the generator stops the thread at its next hand-off
    or the source's next return, and does not wait for either. The thread
    calls `close` as it ends, after its last `stage`. The thread's spans
    (``executor.take``, ``executor.pin``, attribute ``batch``) take `run`
    as their parent and add up in `stats`' take_s and stage_s."""
    stats = stats if stats is not None else StageStats()
    handoff: "queue.Queue" = queue.Queue(maxsize=1)
    stop = threading.Event()
    threading.Thread(target=_stage_loop, name="executor.stage_ahead",
                     args=(iter(source), stage, run, stats, handoff, stop,
                           close),
                     daemon=True).start()
    try:
        while True:
            try:
                got, ready = handoff.get_nowait(), True
            except queue.Empty:
                got, ready = handoff.get(), False
            if got is _END:
                return
            if isinstance(got, _Failed):
                raise got.exc
            yield got, ready
    finally:
        stop.set()
        try:  # a staged item left waiting
            while True:
                handoff.get_nowait()
        except queue.Empty:
            pass


# slots of a pinned ring: one being filled, one waiting in the hand-off
# (``stage_ahead``'s queue of one) and one whose copy in may still run
RING_DEPTH = 3
# bytes each plane's offset in a slot is a multiple of, so a plane's
# device view is as aligned as a buffer of its own for the kernels'
# vector loads
RING_ALIGN = 256


# planes a host copy takes at most: HOST_COPY_MAX_PLANES of hostcopy.cu
_HOST_COPY_MAX_PLANES = 4


class _HostCopyParams(ctypes.Structure):
    """``HostCopyParams`` of csrc/hostcopy.cu."""
    _fields_ = [("src", ctypes.c_void_p * _HOST_COPY_MAX_PLANES),
                ("dst", ctypes.c_void_p * _HOST_COPY_MAX_PLANES),
                ("bytes", ctypes.c_int64 * _HOST_COPY_MAX_PLANES),
                ("planes", ctypes.c_int32),
                ("threads", ctypes.c_int32)]


class PinnedRing:
    """Pinned host slots for batches of one shape: each slot holds a
    batch's planes back to back in one block, allocated once. A slot is
    filled again only after the copy in from it, marked by the event set
    with ``done``, has finished: ``take`` waits for it otherwise.

    `key` is the planes' ``(shape, dtype)`` pairs (``ring_key``). `pin`
    False gives unpinned blocks, filled by ``Tensor.copy_``, for tests
    without a card. One thread uses a ring at a time (``lease_ring``)."""

    def __init__(self, key, pin: bool = True):
        self.key = key
        self.pinned = pin
        self.layout = []  # (offset, nbytes, torch dtype, shape) a plane
        off = 0
        for shape, dtype in key:
            nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
            torch_dtype = torch.from_numpy(np.empty(0, dtype)).dtype
            self.layout.append((off, nbytes, torch_dtype, shape))
            off += -(-nbytes // RING_ALIGN) * RING_ALIGN
        self.nbytes = off
        self.blocks = [torch.empty(off, dtype=torch.uint8, pin_memory=pin)
                       for _ in range(RING_DEPTH)]
        self.events = [None] * RING_DEPTH
        self.next = 0

    def views(self, block: torch.Tensor) -> List[torch.Tensor]:
        """The planes of a slot's `block`, or of a copy of it, as views."""
        return [block[off:off + n].view(dt).view(shape)
                for off, n, dt, shape in self.layout]

    def take(self) -> Tuple[int, bool]:
        """The next slot, in turn, and whether it had to wait for the
        slot's last copy in."""
        slot = self.next
        self.next = (slot + 1) % len(self.blocks)
        event, self.events[slot] = self.events[slot], None
        waited = event is not None and not event.query()
        if waited:
            event.synchronize()
        return slot, waited

    def fill(self, slot: int, planes) -> torch.Tensor:
        """Copy the host `planes` into `slot`; its block. A pinned block is
        filled by the render library's streaming copy (csrc/hostcopy.cu)
        on ``torch.get_num_threads()`` threads with the GIL released, an
        unpinned one by ``Tensor.copy_``."""
        if ring_key(planes) != self.key:
            raise ValueError(f"planes {ring_key(planes)} do not fit a ring "
                             f"of {self.key}")
        block = self.blocks[slot]
        if not self.pinned:
            for a, view in zip(planes, self.views(block)):
                view.copy_(torch.from_numpy(a))
            return block
        # kept referenced until the copy returns
        planes = [np.ascontiguousarray(a) for a in planes]
        params = _HostCopyParams(planes=len(planes),
                                 threads=torch.get_num_threads())
        base = block.data_ptr()
        for i, (a, (off, nbytes, _, _)) in enumerate(zip(planes,
                                                          self.layout)):
            params.src[i] = a.ctypes.data
            params.dst[i] = base + off
            params.bytes[i] = nbytes
        err = load_library().host_copy(ctypes.byref(params), None)
        if err != 0:
            raise RuntimeError(f"host_copy: error {err}")
        return block

    def done(self, slot: int, event) -> None:
        """`event` marks the end of the copy in from `slot`."""
        self.events[slot] = event


def ring_key(planes) -> tuple:
    """A ring's key for host `planes`: their shapes and dtypes."""
    return tuple((tuple(a.shape), np.dtype(a.dtype).str) for a in planes)


# each device's ring, kept between calls; a stage takes it for its
# staging thread's life and gives it back
_RINGS: Dict[torch.device, PinnedRing] = {}
_RINGS_LOCK = threading.Lock()


def lease_ring(device: torch.device, key,
               stats: Optional[StageStats] = None, pin: bool = True
               ) -> PinnedRing:
    """The device's ring for `key`, taken from the process's rings until
    ``return_ring``: the one kept if its key matches, else a new one (the
    kept one of another key is dropped). A second stage on the device
    while the first holds its ring gets a ring of its own. New slots count
    in `stats`' ring_allocs."""
    with _RINGS_LOCK:
        kept = _RINGS.pop(device, None)
    if kept is not None and kept.key == key:
        return kept
    del kept  # freed before the new ring is made
    ring = PinnedRing(key, pin=pin)
    if stats is not None:
        stats.ring_allocs += len(ring.blocks)
    return ring


def return_ring(device: torch.device, ring: PinnedRing) -> None:
    """Keep `ring` as the device's, for the next stage."""
    with _RINGS_LOCK:
        _RINGS[device] = ring


class _HostCopies:
    """The device loop's copies on the CPU, where the render function takes
    and gives host tensors: the arrays go in and come out as they are, and
    there is no event to wait for."""

    def copy_in(self, planes, sp):
        return [torch.from_numpy(a) for a in planes], None

    def close(self) -> None:
        pass

    def wait_in(self, planes, copied) -> None:
        pass

    def rendered(self):
        return None

    def copy_out(self, outs, rendered):
        return outs, None

    def wait_out(self, done) -> None:
        pass


class _CudaCopies:
    """The device loop's copies on a CUDA device: in through a slot of the
    device's pinned ring on the `h2d` stream, which the render (on the
    current stream) waits for; out into pinned memory on the `d2h` stream
    once the render is done; each copy marked by an event."""

    def __init__(self, device: torch.device, stats: StageStats):
        self.device = device
        self.stats = stats
        self.ring: Optional[PinnedRing] = None
        self.compute = torch.cuda.current_stream(device)
        self.h2d = torch.cuda.Stream(device)
        self.d2h = torch.cuda.Stream(device)

    def copy_in(self, planes, sp):
        """On the staging thread: (device planes, their copy's event). The
        planes go into the ring's next slot, then to the device in one
        copy; `sp` (``executor.pin``) gets the slot and whether it
        waited."""
        key = ring_key(planes)
        if self.ring is None or self.ring.key != key:
            self.ring = None  # one of other shapes is dropped, not kept
            self.ring = lease_ring(self.device, key, self.stats)
        ring = self.ring
        slot, waited = ring.take()
        block = ring.fill(slot, planes)
        with torch.cuda.stream(self.h2d):
            dev = torch.empty(ring.nbytes, dtype=torch.uint8,
                              device=self.device)
            dev.copy_(block, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self.h2d)
        ring.done(slot, copied)
        self.stats.ring_staged += 1
        self.stats.ring_waits += waited
        if sp.recording:
            sp.attrs.update(slot=slot, waited=waited)
        return ring.views(dev), copied

    def close(self) -> None:
        """On the staging thread, as it ends: the ring goes back to the
        device's keeping."""
        if self.ring is not None:
            return_ring(self.device, self.ring)
            self.ring = None

    def wait_in(self, planes, copied) -> None:
        self.compute.wait_event(copied)
        for p in planes:
            p.record_stream(self.compute)

    def rendered(self):
        """An event after the render just launched."""
        rendered = torch.cuda.Event()
        rendered.record(self.compute)
        return rendered

    def copy_out(self, outs, rendered):
        """(pinned host outputs, their copy's event)."""
        host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                for o in outs]
        with torch.cuda.stream(self.d2h):
            self.d2h.wait_event(rendered)
            for h, o in zip(host, outs):
                o.record_stream(self.d2h)
                h.copy_(o, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.d2h)
        return host, done

    def wait_out(self, done) -> None:
        done.synchronize()


def render_batches(batches: Iterable[HostBatch], render_fn,
                   device: torch.device,
                   stats: Optional[StageStats] = None) -> Iterator[HostBatch]:
    """Run `render_fn` over host batches on `device`, yielding numpy
    outputs in order. A staging thread copies each batch in, one batch
    ahead (``stage_ahead``), and one batch stays in flight: batch N is
    yielded once batch N+1 is rendered. The yielded arrays (in pinned
    buffers on CUDA, the render's own outputs on the CPU) stay valid while
    referenced. An exception of `batches` or of the staging is raised
    after the batches before it are yielded.

    Spans (``spans``), whose seconds add up in `stats`: ``executor.run``
    over the call (attribute ``first_yield_ns``: its first output, ns
    after its start), and per batch (attribute ``batch``), on the loop's
    thread, ``executor.stage`` (the next staged batch taken and its copy
    in waited for on the device; attribute ``ready``: it was already
    staged), ``executor.render`` (attributes ``layout`` and ``interp``
    where `render_fn` names them, as ``make_render_fn``'s and
    ``make_sharded_render_fn``'s do after each call), ``executor.out`` and
    ``executor.wait``, and on the staging thread ``executor.take`` and
    ``executor.pin`` (the pageable -> pinned copy and the copy in enqueued
    on CUDA; attributes ``slot`` and ``waited``: the pinned ring's slot,
    and whether it waited for the slot's last copy in)."""
    stats = stats if stats is not None else StageStats()
    source = iter(batches)
    with span("executor.run") as run:
        copies = (_CudaCopies(device, stats) if device.type == "cuda"
                  else _HostCopies())

        def stage(item, sp):
            y, u, v, count = item
            planes, copied = copies.copy_in((y, u, v), sp)
            return planes, copied, count

        def finish(batch) -> HostBatch:
            host, done, count, i = batch
            with span("executor.wait", run, batch=i) as sp:
                copies.wait_out(done)
            stats.wait_s += sp.seconds
            stats.batches += 1
            run.mark("first_yield_ns")
            return (*(h.numpy() for h in host), count)

        staged = stage_ahead(source, stage, run, stats, copies.close)
        in_flight = None  # (host outputs, done event, count, batch index)
        failed = None
        try:
            for i in itertools.count():
                with span("executor.stage", run, batch=i) as sp:
                    try:
                        got = next(staged, None)
                    except Exception as exc:  # raised after the batches
                        got, failed = None, exc
                    if got is not None:
                        (planes, copied, count), ready = got
                        sp.attrs["ready"] = ready
                        stats.staged_ready += ready
                        copies.wait_in(planes, copied)
                if got is None:
                    break
                with span("executor.render", run, batch=i) as sp:
                    outs = render_fn(*planes)
                    rendered = copies.rendered()
                    # the render function's own account of this call
                    layout = getattr(render_fn, "layout", None)
                    if sp.recording and layout is not None:
                        sp.attrs.update(layout=layout,
                                        interp=render_fn.interp)
                stats.render_s += sp.seconds
                with span("executor.out", run, batch=i) as sp:
                    host, done = copies.copy_out(outs, rendered)
                stats.out_s += sp.seconds
                prev, in_flight = in_flight, (host, done, count, i)
                if prev is not None:
                    yield finish(prev)
            if in_flight is not None:
                yield finish(in_flight)
            if failed is not None:
                raise failed
        finally:
            staged.close()


def _export_profile(prof, profile_dir: Path, log) -> None:
    """Stop `prof`, write its chrome trace and the spans it saw into
    `profile_dir`. A diagnostic: a failure is logged, not raised."""
    try:
        prof.stop()
        profile_dir.mkdir(parents=True, exist_ok=True)
        trace = profile_dir / "render_trace.json"
        prof.export_chrome_trace(str(trace))
    except Exception as exc:
        log(f"engine: profiler trace not written: {exc}")
        return
    try:
        n = write_spans(profile_dir / "spans.jsonl", prof, trace)
    except Exception as exc:
        log(f"engine: spans not written: {exc}")
        return
    if n:
        log(f"engine: {n} spans -> {profile_dir / 'spans.jsonl'}")
    else:
        log("engine: no spans recorded; spans.jsonl not written")


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
    use_mesh: Optional[bool] = None,
) -> StageResult:
    """Render one stage file to file. `lut` is a LutTable, a Coarse2Table,
    the JAX package's PreparedLut, a parsed Lut3D, or None. An unusable `device`
    raises; media and render failures return a failed StageResult.
    `lut_strategy` is accepted for parity with the JAX executor; both
    values run the same kernels. `use_mesh`: split the batch across every
    visible card; None does so when `device` is plain ``"cuda"`` and there
    is more than one card."""
    del lut_strategy
    mesh = stage_devices(device, use_mesh)
    dev = mesh[0]
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
        # the batch size follows the input geometry, as in the JAX executor
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

        if len(mesh) > 1:
            ndev = len(mesh)
            bsz = max(ndev, ((bsz + ndev - 1) // ndev) * ndev)
            render_fn = make_sharded_render_fn(lut, cfg, mesh)
            stats.split = render_fn.stats
            log(f"engine: frame batch split over {ndev} devices "
                f"({', '.join(map(str, mesh))}), batch={bsz}")
        else:
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
            ys, us, vs = [], [], []
            with span("executor.decode") as sp:
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
                            ys.append(ys[-1]); us.append(us[-1])
                            vs.append(vs[-1])
                        batch_q.put(("batch", np.stack(ys), np.stack(us),
                                     np.stack(vs), count))
                    batch_q.put(("eof", None, None, None, 0))
                except Exception as exc:  # propagated by the render loop
                    batch_q.put(("error", exc, None, None, 0))
            stats.decode_s += sp.seconds

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
                with span("executor.encode") as sp:
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
                stats.encode_s += sp.seconds
                if enc_error:
                    return

        prof = None
        if profile_dir:
            # device-level trace of the stage's loops, and their spans
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            begin_spans()
            log(f"engine: torch profiler trace -> {profile_dir}")

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

        by_interp0 = dict(fused420.launches_by_interp)
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
            stats.launches_by_interp = {
                k: n - by_interp0.get(k, 0)
                for k, n in fused420.launches_by_interp.items()
                if n > by_interp0.get(k, 0)}
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
            try:  # ends the source of a staging thread still waiting on it
                batch_q.put_nowait(("eof", None, None, None, 0))
            except queue.Full:
                pass
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
            if prof is not None:  # after the loops, so it holds their spans
                _export_profile(prof, Path(profile_dir), log)

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
