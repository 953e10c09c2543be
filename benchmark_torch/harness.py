"""One run of one cell: set-up, the measured window, the trace, the check.

The window drives the port as its task runner and stage executor do, one
job at a time: ``tasks.runner.load_lut_table`` (parse and upload, through
the runner's LRU), ``ops.render.make_render_fn`` (or, on several cards,
``parallel.make_sharded_render_fn`` with the batch rounded up to the card
count), then ``engine.executor.render_batches``. Two threads stand in for
the codecs, shaped like ``run_stage``'s: a producer hands over host
batches of seeded frames (a queue of 2) and a consumer takes each output
(a queue of 2), as the encoder would. The producer's batches are stacked
once at set-up, not per batch as ``run_stage``'s decode loop stacks them,
so ``fps`` is the device loop's ceiling, not a file's rate.

After the window closes, a sample of the delivered batches, drawn from the
seed, is held against the plain reference (``reference.py``) at the timed
sizes: the integer planes a user's encoder would have received.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import queue
import random
import subprocess
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

from . import reference, spec, traffic
from .frames import chroma_shape, device_frames

# host batches queued ahead of the device loop, outputs queued for the
# consumer: run_stage's two queues
QUEUE_DEPTH = 2
# batches of the warm-up job
WARM_BATCHES = 8
# short jobs after the warm-up job: the device loop takes two CUDA streams
# from PyTorch's pool of 32 a job, and the caching allocator keeps blocks
# per stream, so a window's first 16 jobs would otherwise allocate
WARM_JOBS = 17
# buffers for a job's padded last batch: the two queued, the one the
# device loop is staging, the one being filled, and one to spare
RING = QUEUE_DEPTH + 3
# torch's intra-op threads in a run: the device loop's pageable -> pinned
# copy is split over that pool, and one as wide as the machine waits on
# whichever core the host's other work holds up
HOST_THREADS = 2


def log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


@dataclass
class JobRec:
    look: int
    start: float
    load_s: float = 0.0
    fn_s: float = 0.0
    first: Optional[float] = None   # first output batch at the consumer


@dataclass
class BatchRec:
    job: JobRec
    count: int
    pool: List[int]
    taken: float                       # render_batches took it
    yielded: Optional[float] = None    # render_batches yielded its output
    delivered: Optional[float] = None  # the consumer received it


@dataclass
class Run:
    """What a run measured: the metric readers read this."""

    cell: spec.Cell
    seconds: float
    setup_s: float
    batch: int
    cards: List[int]
    shape: tuple                 # (h, w) of the input frames
    lut_size: int
    t0: float = 0.0
    t_close: float = 0.0
    jobs: List[JobRec] = field(default_factory=list)
    batches: List[BatchRec] = field(default_factory=list)
    trace: object = None
    error: Optional[str] = None


class Sampler:
    """k delivered batches: the first batch to reach the consumer after
    each of k moments of the window drawn from the seed. It keeps the
    arrays ``render_batches`` yielded (they stay valid while referenced)
    and copies nothing, so the window pays for no sample; the check reads
    them once the window has closed."""

    def __init__(self, k: int, seed: int, t0: float, seconds: float):
        rng = random.Random(seed)
        self.due = sorted(t0 + seconds * rng.random() for _ in range(k))
        self.kept = []

    def offer(self, rec: BatchRec, planes) -> None:
        if not self.due or rec.delivered < self.due[0]:
            return
        while self.due and self.due[0] <= rec.delivered:
            self.due.pop(0)
        self.kept.append((rec, planes))


def card_line() -> str:
    """The cards' names and power limits, as nvidia-smi gives them.
    (probes/harness.card_line)"""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"
    return "; ".join(out.stdout.strip().splitlines())


def derive_config(cell: spec.Cell):
    """The RenderConfig the port's policy derives for the cell's jobs, as
    run_stage derives it: build_render_spec, the encoder's pixel format,
    derive_render_config. Raises where it departs from the pipeline that
    the configuration states."""
    from lut_renderer_tpu_torch.engine.config import (
        derive_render_config, effective_output_pix_fmt)
    from lut_renderer_tpu_torch.models import ProcessingParams, VideoInfo
    from lut_renderer_tpu_torch.models.video_info import infer_bit_depth
    from lut_renderer_tpu_torch.plan import build_render_spec

    probe = dict(cell.config["probe"])
    probe["bit_depth"] = infer_bit_depth(probe["pix_fmt"])
    info = VideoInfo(**probe)
    params = ProcessingParams.from_dict({**cell.config.get("params", {}),
                                         **cell.traffic.get("params", {})})
    rspec = build_render_spec(Path("clip.mov"), Path("clip_out.mp4"), params,
                              Path("look.cube"), info)
    rspec = dataclasses.replace(
        rspec, pix_fmt=effective_output_pix_fmt(rspec, info))
    cfg = derive_render_config(rspec, info)
    want = dict(cell.config["pipeline"], resize=resize_of(cell))
    got = {k: getattr(cfg, k) for k in want}
    got["resize"] = tuple(got["resize"]) if got["resize"] else None
    if got != want:
        raise RuntimeError(f"the policy derives {got} for {cell.name}; the "
                           f"configuration states {want}")
    return cfg


def resize_of(cell: spec.Cell):
    """(out_w, out_h) of the mix's delivery size, or None."""
    text = cell.traffic.get("params", {}).get("resolution")
    if not text:
        return None
    w, h = (int(x) for x in text.lower().split("x"))
    return (w, h)


def _sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class Bench:
    """A cell's set-up and its job loop on `devices`."""

    def __init__(self, cell: spec.Cell, seed: int, devices, device_arg: str,
                 traced: bool, here: Path = spec.HERE):
        from lut_renderer_tpu_torch.engine.executor import (
            _pick_batch_size, render_batches)
        from lut_renderer_tpu_torch.ops.render import make_render_fn
        from lut_renderer_tpu_torch.parallel import make_sharded_render_fn
        from lut_renderer_tpu_torch.tasks.runner import load_lut_table

        self.spec, self.traced = cell, traced
        self.devices, self.device_arg = devices, device_arg
        self.render_batches = render_batches
        self.load_lut_table = load_lut_table
        self.make_render_fn = make_render_fn
        self.make_sharded_render_fn = make_sharded_render_fn
        probe = cell.config["probe"]
        self.h, self.w = probe["height"], probe["width"]
        self.pipe = cell.config["pipeline"]
        self.resize = resize_of(cell)
        self.n = int(cell.config["lut_size"])
        self.cfg = derive_config(cell)
        bsz = _pick_batch_size(self.w, self.h)
        if len(devices) > 1:
            k = len(devices)
            bsz = max(k, -(-bsz // k) * k)
        self.batch = bsz
        self.looks = [traffic.look_path(here / "looks", cell.traffic, self.n,
                                        i)
                      for i in range(int(cell.traffic["looks"]))]
        depth, sub = self.pipe["in_depth"], self.pipe["in_subsampling"]
        self.pool = device_frames(seed, int(cell.traffic["pool_frames"]),
                                  self.h, self.w, depth, sub, devices[0])
        # every whole batch a job can take (bsz frames from each start in
        # the pool), stacked once here; a job's last, padded batch is
        # stacked as it comes into a small ring. Stacking each batch in the
        # window, as run_stage's decode loop does, put a fresh 25-400 MB
        # copy beside the program's pinned staging and set the pace itself
        # (17.4 fps at 8K): the window measures the device loop alone.
        size = len(self.pool[0])
        self.batches = [tuple(np.stack([p[(s + j) % size] for j in range(bsz)])
                              for p in self.pool) for s in range(size)]
        self.ring = [tuple(np.empty_like(p) for p in self.batches[0])
                     for _ in range(RING)]
        self.ring_next = 0
        self.render_fn_factory: Callable = self._render_fn

    def _render_fn(self, lut):
        if len(self.devices) > 1:
            return self.make_sharded_render_fn(lut, self.cfg, self.devices)
        return self.make_render_fn(lut, self.cfg, self.devices[0])

    def span(self, name: str):
        if not self.traced:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"bench::{name}")

    def run_job(self, job: traffic.Job, run: Run, close: float,
                sampler: Optional[Sampler]) -> None:
        """One job through the runner's entries and the device loop. Stops
        taking batches once `close` has passed and the job has taken one."""
        rec = JobRec(job.look, time.perf_counter())
        run.jobs.append(rec)
        with self.span("lut_load"):
            lut = self.load_lut_table(self.looks[job.look], self.device_arg)
            if self.traced:
                _sync(self.devices)
        t1 = time.perf_counter()
        rec.load_s = t1 - rec.start
        with self.span("render_fn"):
            fn = self.render_fn_factory(lut)
            if self.traced:
                _sync(self.devices)
        rec.fn_s = time.perf_counter() - t1

        batch_q: "queue.Queue" = queue.Queue(maxsize=QUEUE_DEPTH)
        out_q: "queue.Queue" = queue.Queue(maxsize=QUEUE_DEPTH)
        stop = threading.Event()
        size, bsz = len(self.pool[0]), self.batch

        def produce():
            i = 0
            while not stop.is_set() and (job.frames is None
                                         or i < job.frames):
                k = bsz if job.frames is None else min(bsz, job.frames - i)
                idx = [(job.pool_start + i + j) % size for j in range(k)]
                if k == bsz:
                    item = self.batches[idx[0]] + (k, idx)
                else:  # padded with its last frame, as run_stage pads
                    full = idx + [idx[-1]] * (bsz - k)
                    ring = self.ring[self.ring_next % len(self.ring)]
                    self.ring_next += 1
                    item = tuple(np.stack([p[t] for t in full], out=buf)
                                 for p, buf in zip(self.pool, ring)) + (k, idx)
                while not stop.is_set():
                    try:
                        batch_q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                i += k
            batch_q.put(None)

        def consume():
            while True:
                item = out_q.get()
                if item is None:
                    return
                planes, b = item
                b.delivered = time.perf_counter()
                if rec.first is None:
                    rec.first = b.delivered
                if sampler is not None:
                    sampler.offer(b, [p[:b.count] for p in planes])

        pending: deque = deque()

        def host_batches():
            while True:
                if pending_taken[0] and time.perf_counter() >= close:
                    return
                with self.span("take"):
                    item = batch_q.get()
                if item is None:
                    return
                y, u, v, k, idx = item
                b = BatchRec(rec, k, idx, time.perf_counter())
                run.batches.append(b)
                pending.append(b)
                pending_taken[0] += 1
                yield y, u, v, k

        pending_taken = [0]
        producer = threading.Thread(target=produce, daemon=True)
        consumer = threading.Thread(target=consume, daemon=True)
        producer.start()
        consumer.start()
        try:
            for y, u, v, _ in self.render_batches(host_batches(), fn,
                                                  self.devices[0]):
                b = pending.popleft()
                b.yielded = time.perf_counter()
                with self.span("emit"):
                    out_q.put(((y, u, v), b))
        finally:
            stop.set()
            with self.span("job_end"):
                while producer.is_alive():
                    try:
                        while True:
                            batch_q.get_nowait()
                    except queue.Empty:
                        pass
                    producer.join(timeout=0.5)
                out_q.put(None)
                consumer.join()


def launch_counts() -> dict:
    from lut_renderer_tpu_torch.ops import fused420, lut3d

    return {"B": fused420.launches, "B coarse2": fused420.coarse2_launches,
            "A": lut3d.launches, "C": lut3d.coarse2_launches}


def check(cell: "Bench", samples, limits: dict) -> dict:
    """The sampled outputs against the reference on the first device:
    {name: (value, limit)} of each number compared, and the frames."""
    dev = cell.devices[0]
    tables = {}
    worst, differ, total, frames, bad_shape = 0, 0, 0, 0, 0
    ow, oh = cell.resize or (cell.w, cell.h)
    osub = cell.pipe["out_subsampling"]
    shapes = [(oh, ow)] + [chroma_shape(oh, ow, osub)] * 2
    for b, got in samples:
        if b.job.look not in tables:
            tables[b.job.look] = torch.from_numpy(traffic.look_table(
                cell.spec.traffic, cell.n, b.job.look)).to(dev)
        for f, t in enumerate(b.pool):
            planes = [torch.from_numpy(p[t:t + 1]).to(dev) for p in cell.pool]
            want = reference.render(*planes, tables[b.job.look], cell.pipe,
                                    cell.resize)
            for g, w, shape in zip(got, want, shapes):
                if tuple(g.shape) != (b.count, *shape):
                    bad_shape += 1
                    continue
                d = (torch.from_numpy(g[f:f + 1].astype(np.int32)).to(dev)
                     - w.to(torch.int32)).abs()
                worst = max(worst, int(d.max()))
                differ += int((d > 0).sum())
                total += d.numel()
            frames += 1
    share = differ / total if total else 1.0
    return {"frames_compared": frames, "bad_shapes": bad_shape,
            "numbers": {"max_code_diff": (worst, limits["max_code_diff"]),
                        "diff_share": (share, limits["diff_share"])}}


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             t_start: float, root: Path, devices=None,
             device_arg: Optional[str] = None,
             hook: Optional[Callable] = None, here: Path = spec.HERE) -> dict:
    """One run of cell `name`: the result line's object. `devices` None
    takes the cell's cards (and fails without them); tests pass CPU
    devices. `hook(cell)` may replace parts of the timed path."""
    cell_spec = spec.load_cell(name, root, here)
    if devices is None:
        if not torch.cuda.is_available():
            raise SystemExit("bench: torch sees no CUDA device; the "
                             "benchmark runs on the card only")
        if torch.cuda.device_count() < cell_spec.chips:
            raise SystemExit(f"bench: {cell_spec.name} needs "
                             f"{cell_spec.chips} cards, torch sees "
                             f"{torch.cuda.device_count()}")
        devices = [torch.device("cuda", i) for i in range(cell_spec.chips)]
        device_arg = "cuda:0" if cell_spec.chips == 1 else "cuda"
        if cell_spec.chips > 1:
            from lut_renderer_tpu_torch.engine.executor import stage_devices

            mesh = stage_devices(device_arg)
            if mesh != devices:
                raise SystemExit(f"bench: the executor would split over "
                                 f"{mesh}, the cell asks for {devices}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log(f"cards: {card_line()}; torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
            f"{torch.cuda.device_count()} visible, {cell_spec.chips} used")
    cell = Bench(cell_spec, seed, devices, device_arg, traced, here)
    if hook is not None:
        hook(cell)
    plan = traffic.jobs(cell_spec.traffic, seed)
    run = Run(cell_spec, seconds, 0.0, cell.batch,
              sorted({d.index or 0 for d in devices}), (cell.h, cell.w),
              cell.n)

    # warm-up: every look through the runner's loader once, as a daemon
    # that has served them holds them; then one job of the cell's own
    # shapes, WARM_BATCHES batches, through the same entries (kernel build,
    # pinned and device buffers, the render function's constants), and
    # WARM_JOBS short ones. Their records are dropped.
    for path in cell.looks:
        cell.load_lut_table(path, cell.device_arg)
    warm = Run(cell_spec, seconds, 0.0, cell.batch, run.cards, run.shape,
               cell.n)
    first = next(plan)
    cell.run_job(dataclasses.replace(first, frames=WARM_BATCHES * cell.batch),
                 warm, float("inf"), None)
    for _ in range(WARM_JOBS):
        cell.run_job(dataclasses.replace(first, frames=2 * cell.batch), warm,
                     float("inf"), None)
    _sync(devices)
    for d in devices:
        if d.type == "cuda":
            torch.cuda.reset_peak_memory_stats(d)
    counts0 = launch_counts()

    prof = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if devices[0].type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    window_span = cell.span("window")
    window_span.__enter__()
    run.t0 = time.perf_counter()
    run.setup_s = run.t0 - t_start
    run.t_close = run.t0 + seconds
    sampler = Sampler(int(cell_spec.workload["check_batches"]),
                      seed ^ 0x5EED, run.t0, seconds)
    job = first
    try:
        while True:
            cell.run_job(job, run, run.t_close, sampler)
            if time.perf_counter() >= run.t_close:
                break
            job = next(plan)
    except Exception as exc:  # the program failed: the run is not correct
        run.error = f"{type(exc).__name__}: {exc}"
        log(f"the timed path raised: {run.error}")
    _sync(devices)
    window_span.__exit__(None, None, None)
    if prof is not None:
        prof.stop()
    counts = {k: v - counts0[k] for k, v in launch_counts().items()}
    peak = max((torch.cuda.max_memory_allocated(d) for d in devices
                if d.type == "cuda"), default=0)

    if prof is not None:
        from .trace import from_profiler

        t = time.perf_counter()
        run.trace = from_profiler(prof) if devices[0].type == "cuda" else None
        del prof
        log(f"trace read in {time.perf_counter() - t:.1f} s")
        if run.trace is not None:
            log(f"host operations of the window's thread: "
                f"{run.trace.top_host_ops()}")
    layer = run.cell.per_layer if traced else run.cell.end_to_end
    metrics = spec.read_metrics(layer, run, here)

    # the window's pinned and device buffers go back before the reference
    if devices[0].type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    with torch.no_grad():
        result = check(cell, sampler.kept, cell_spec.workload["limits"])
    log(f"reference compared {result['frames_compared']} frames of "
        f"{len(sampler.kept)} sampled batches in "
        f"{time.perf_counter() - t:.1f} s")

    taken = [b for b in run.batches if b.taken < run.t_close]
    attempted = sum(b.count for b in taken)
    failed = sum(b.count for b in taken if b.delivered is None)
    numbers = result["numbers"]
    correct = (run.error is None and failed == 0 and not result["bad_shapes"]
               and result["frames_compared"] > 0
               and all(v <= lim for v, lim in numbers.values()))
    device = {"platform": "gpu" if devices[0].type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(devices[0])
                       if devices[0].type == "cuda" else "cpu"),
              "count": len(devices), "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if traced and run.trace is not None:
        tr = run.trace
        device["busy_s"] = tr.busy_s(run.cards)
        device["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.top_device_ops(),
                            "idle_gaps": tr.idle_gaps(run.cards)}
    jobs_in = [j for j in run.jobs if j.start < run.t_close]
    log(f"{cell_spec.name} seed {seed}: {len(jobs_in)} jobs, {len(taken)} "
        f"batches of {cell.batch}, {attempted} frames taken in "
        f"{seconds} s; launches {counts}; setup {run.setup_s:.3f} s; "
        f"error {run.error}")
    for k, v in metrics.items():
        log(f"metric {k} = {v['value']!r} {v['unit']}")
    out["launches"] = counts
    out["compared"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in numbers.items()}
    for k, (v, lim) in numbers.items():
        log(f"compared {k} = {v!r} (limit {lim!r})")
    return out


def main(argv, t_start: float, root: Path) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    torch.set_num_threads(HOST_THREADS)
    log(f"torch intra-op threads: {torch.get_num_threads()}")
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   t_start, root)
    print(json.dumps(out), flush=True)
    return 0
