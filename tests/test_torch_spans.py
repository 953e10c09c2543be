"""The port's spans and LUT cache counters (``lut_renderer_tpu_torch.spans``,
``tasks.runner``) on the CPU: recording follows the torch profiler and
nothing else, the spans of ``render_batches`` nest under their call, the
anchor puts them on the profiler's clock, the buffer's cap, the LRU's
counters, ``StageStats``' split, and the operator's views of both."""

import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler

from lut_renderer_tpu.colorcore import Lut3D, write_cube_file
from lut_renderer_tpu.utils.fixtures import make_gradient_clip
from lut_renderer_tpu_torch import spans
from lut_renderer_tpu_torch.engine.executor import (StageStats,
                                                    render_batches, run_stage)
from lut_renderer_tpu_torch.models import ProcessingParams
from lut_renderer_tpu_torch.ops.render import RenderConfig, make_render_fn
from lut_renderer_tpu_torch.plan import build_render_spec
from lut_renderer_tpu_torch.tasks import runner

from torch_parity import planes

torch.set_num_threads(1)
CPU = [torch.profiler.ProfilerActivity.CPU]


def _batches(n=3):
    return [(*planes(s, 2, 16, 32, 8), 2 if s < n - 1 else 1)
            for s in range(n)]


def _render_fn():
    return make_render_fn(None, RenderConfig(apply_lut=False), "cpu")


def _profiled(fn):
    """fn() under a CPU profile: (its result, the stopped profile). A span
    before the profile finds none, as the program's own spans do between
    two profiles, so the first span under it begins a new recording."""
    with spans.span("between"):
        pass
    prof = torch.profiler.profile(activities=CPU)
    prof.start()
    try:
        out = fn()
    finally:
        prof.stop()
    return out, prof


def _events(prof, name):
    """(start_ns, end_ns) of the profile's host events called `name`."""
    evs = [ev for ev in prof.profiler.kineto_results.events()
           if ev.name() == name]
    return sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns())
                  for ev in evs)


def test_the_profiler_flag_is_one_global_for_every_thread():
    """Recording reads torch.autograd.profiler._is_profiler_enabled: a
    module global that a running profiler sets for every thread (the
    C++ flag torch._C._autograd._profiler_enabled is per thread)."""
    assert autograd_profiler._is_profiler_enabled is False
    seen = []

    def look():
        seen.append(autograd_profiler._is_profiler_enabled)

    def on_another_thread():
        t = threading.Thread(target=look)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()

    _profiled(on_another_thread)
    assert seen == [True]
    assert autograd_profiler._is_profiler_enabled is False


def test_nothing_is_recorded_without_a_profiler(monkeypatch, tmp_path):
    def refuse(*a, **k):
        raise AssertionError("record_function on the hot path")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    before, anchors = spans.records(), spans._anchors[:]
    stats = StageStats()
    outs = list(render_batches(iter(_batches()), _render_fn(),
                               torch.device("cpu"), stats))
    cube = write_cube_file(tmp_path / "l.cube", Lut3D.identity(5))
    runner.load_lut_table(cube, "cpu")
    assert [o[3] for o in outs] == [2, 2, 1]
    assert spans.records() == before and spans._anchors == anchors
    # the timings are taken all the same
    assert stats.batches == 3 and stats.render_s > 0 and stats.take_s > 0


def test_cpu_render_batches_records_nested_spans():
    stats = StageStats()
    _profiled(lambda: list(render_batches(iter(_batches()), _render_fn(),
                                          torch.device("cpu"), stats)))
    recs = spans.records()
    (run,) = [r for r in recs if r.name == "executor.run"]
    kids = [r for r in recs if r.name != "executor.run"]
    assert {r.name for r in kids} == {"executor.take", "executor.render"}
    assert all(r.parent == run.id and r.call == run.id for r in kids)
    assert run.parent is None and run.call == run.id
    takes = [r.attrs["batch"] for r in kids if r.name == "executor.take"]
    renders = [r.attrs["batch"] for r in kids if r.name == "executor.render"]
    assert takes == [0, 1, 2, 3] and renders == [0, 1, 2]  # 4th: the end
    for r in kids:
        assert run.start_ns <= r.start_ns <= r.end_ns <= run.end_ns
        assert r.thread == run.thread == threading.get_native_id()
    first = run.attrs["first_yield_ns"]
    assert 0 < first < run.end_ns - run.start_ns
    render0 = next(r for r in kids if r.name == "executor.render")
    assert first >= render0.end_ns - run.start_ns
    assert spans.dropped() == 0


def test_stage_stats_are_the_sums_of_the_spans():
    stats = StageStats()
    _profiled(lambda: list(render_batches(iter(_batches()), _render_fn(),
                                          torch.device("cpu"), stats)))
    for step in ("take", "render"):
        total = sum(r.end_ns - r.start_ns for r in spans.records()
                    if r.name == f"executor.{step}")
        assert getattr(stats, f"{step}_s") == pytest.approx(total * 1e-9)
    assert stats.stage_s == stats.out_s == stats.wait_s == 0.0


def test_records_from_a_second_thread_are_kept():
    def two_threads():
        def work():
            with spans.span("second", k=1):
                pass
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        with spans.span("first"):
            pass
        return t.native_id

    other, _ = _profiled(two_threads)
    by = {r.name: r for r in spans.records()}
    assert by["second"].thread == other != by["first"].thread
    assert by["second"].attrs == {"k": 1}


def test_recording_stops_with_the_profiler_and_restarts_fresh():
    _profiled(lambda: spans.span("a").__enter__().__exit__())
    first = spans._anchors[:]
    with spans.span("after"):
        pass
    assert [r.name for r in spans.records()] == ["a"]
    _profiled(lambda: spans.span("b").__enter__().__exit__())
    assert [r.name for r in spans.records()] == ["b"]
    assert len(spans._anchors) == spans.ANCHORS
    assert spans._anchors[0][0] > first[-1][1]


def test_begin_starts_a_recording_where_no_span_ran_between_profiles():
    _profiled(lambda: spans.span("a").__enter__().__exit__())
    # no span between the two profiles: the recording goes on
    prof = torch.profiler.profile(activities=CPU)
    prof.start()
    with spans.span("b"):
        pass
    assert [r.name for r in spans.records()] == ["a", "b"]
    spans.begin()
    with spans.span("c"):
        pass
    prof.stop()
    assert [r.name for r in spans.records()] == ["c"]
    assert len(_events(prof, spans.ANCHOR)) == spans.ANCHORS
    assert spans.clock_offset_ns(_events(prof, spans.ANCHOR)) is not None


def test_anchor_puts_a_span_on_the_profilers_clock():
    def nested():
        with spans.span("begins the recording"):
            pass
        for _ in range(20):
            with torch.profiler.record_function("outer"):
                with spans.span("inner"):
                    time.sleep(0.002)

    _, prof = _profiled(nested)
    offset, half = spans.clock_offset_ns(_events(prof, spans.ANCHOR))
    assert half < 50_000
    inner = [r for r in spans.records() if r.name == "inner"]
    outer = _events(prof, "outer")
    assert len(inner) == len(outer) == 20
    # each span lies inside its range, as the profiler recorded it, and
    # starts right after it (what follows the span is the range's exit)
    slack = half + 5_000
    for r, (s, e) in zip(inner, outer):
        assert s - slack <= r.start_ns + offset <= r.end_ns + offset \
            <= e + slack
    gaps = sorted(r.start_ns + offset - s for r, (s, _) in zip(inner, outer))
    assert gaps[len(gaps) // 2] < 50_000


def test_clock_offset_refuses_ranges_of_another_recording():
    _, prof = _profiled(lambda: spans.span("x").__enter__().__exit__())
    ranges = _events(prof, spans.ANCHOR)
    assert len(ranges) == spans.ANCHORS
    assert spans.clock_offset_ns(ranges) is not None
    assert spans.clock_offset_ns(ranges[1:]) is None
    assert spans.clock_offset_ns([]) is None
    # ranges that no single offset fits
    shifted = [ranges[0]] + [(s + 10 ** 9, e + 10 ** 9)
                             for s, e in ranges[1:]]
    assert spans.clock_offset_ns(shifted) is None


def test_the_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(spans, "CAP", 5)

    def eight():
        for i in range(8):
            with spans.span("s", i=i):
                pass

    _profiled(eight)
    assert [r.attrs["i"] for r in spans.records()] == [0, 1, 2, 3, 4]
    assert spans.dropped() == 3
    monkeypatch.setattr(spans, "CAP", 1 << 20)
    _profiled(eight)
    assert len(spans.records()) == 8 and spans.dropped() == 0


def test_lut_cache_counters_and_hit_spans(monkeypatch, tmp_path):
    monkeypatch.setattr(runner, "_LUT_CACHE", {})
    for name in ("lut_hits", "lut_misses", "lut_evictions"):
        monkeypatch.setattr(runner, name, 0)
    cubes = [write_cube_file(tmp_path / f"l{i}.cube", Lut3D.identity(3 + i))
             for i in range(5)]
    order = [0, 1, 2, 3, 0, 4]   # 6 loads of 5 looks through 4 entries

    def loads():
        return [runner.load_lut_table(cubes[i], "cpu") for i in order]

    luts, _ = _profiled(loads)
    assert luts[4] is luts[0]
    assert runner.lut_cache_stats() == {"hits": 1, "misses": 5,
                                        "evictions": 1, "entries": 4}
    recs = [r for r in spans.records() if r.name == "runner.lut_load"]
    assert [r.attrs["hit"] for r in recs] == [False] * 4 + [True, False]
    assert [r.attrs["size"] for r in recs] == [3 + i for i in order]
    # the evicted look (the least recent, 1) parses again
    runner.load_lut_table(cubes[1], "cpu")
    assert runner.lut_misses == 6 and runner.lut_evictions == 2


def test_stage_stats_summary_shows_the_split():
    stats = StageStats(frames_in=8, frames_out=8, wall_s=2.0, decode_s=0.5,
                       take_s=0.004, stage_s=0.04, render_s=0.02,
                       out_s=0.008, wait_s=0.132, encode_s=1.0, batches=4)
    line = stats.summary()
    assert line.startswith("8 frames in 2.00s (4.0 fps overall; ")
    assert "decode 16.0 fps, device loop 40.0 fps, encode 8.0 fps" in line
    assert line.endswith("ms a batch: take 1.00, stage 10.00, "
                         "render 5.00, out 2.00, wait 33.00")
    assert StageStats().summary().endswith("ms a batch: n/a")


def test_server_status_reports_the_lut_cache(tmp_path, monkeypatch):
    from lut_renderer_tpu_torch.app.server import QueueServer

    monkeypatch.setattr(runner, "_LUT_CACHE", {})
    for name in ("lut_hits", "lut_misses", "lut_evictions"):
        monkeypatch.setattr(runner, name, 0)
    cube = write_cube_file(tmp_path / "l.cube", Lut3D.identity(5))
    runner.load_lut_table(cube, "cpu")
    runner.load_lut_table(cube, "cpu")
    server = QueueServer(tmp_path / "s.sock", device="cpu")
    resp = server.handle_request({"op": "status"})
    assert resp["ok"] and resp["tasks"] == []
    assert resp["lut_cache"] == {"hits": 1, "misses": 1, "evictions": 0,
                                 "entries": 1}


def test_profile_dir_writes_spans_on_the_traces_clock(tmp_path):
    from lut_renderer_tpu_torch.hostio import probe_video

    clip = make_gradient_clip(tmp_path / "c.mp4", 64, 48, fps=25.0, frames=6)
    info = probe_video(clip)
    spec = build_render_spec(Path(clip), tmp_path / "o.mkv",
                             ProcessingParams(video_codec="ffv1"), None, info)
    logs = []
    res = run_stage(spec, info, None, device="cpu", batch_size=2,
                    profile_dir=str(tmp_path / "prof"), log_cb=logs.append)
    assert res.ok, res.error
    assert res.stats.batches == 3
    lines = (tmp_path / "prof" / "spans.jsonl").read_text().splitlines()
    head, events = json.loads(lines[0]), [json.loads(x) for x in lines[1:]]
    assert head["args"]["spans"] == len(events)
    assert head["args"]["dropped"] == 0
    names = {e["name"] for e in events}
    assert {"executor.run", "executor.take", "executor.render",
            "executor.decode", "executor.encode"} <= names
    # the profile stops after the encode thread retires: its last batch too
    assert sum(e["name"] == "executor.encode" for e in events) == 3
    assert any("spans ->" in m for m in logs)
    # every render span encloses the render's own torch ops in the trace
    trace = json.loads((tmp_path / "prof" / "render_trace.json").read_text())
    ops = [e for e in trace["traceEvents"] if e.get("ph") == "X"
           and e.get("cat") == "cpu_op"]
    renders = [e for e in events if e["name"] == "executor.render"]
    assert len(renders) == 3
    for r in renders:
        inside = [o for o in ops if o["tid"] == r["tid"]
                  and r["ts"] - 50 <= o["ts"]
                  and o["ts"] + o["dur"] <= r["ts"] + r["dur"] + 50]
        assert inside, r
    assert all(np.isfinite(e["ts"]) for e in events)


def _stage_with_profile(tmp_path, logs):
    from lut_renderer_tpu_torch.hostio import probe_video

    clip = make_gradient_clip(tmp_path / "c.mp4", 64, 48, fps=25.0, frames=6)
    info = probe_video(clip)
    spec = build_render_spec(Path(clip), tmp_path / "o.mkv",
                             ProcessingParams(video_codec="ffv1"), None, info)
    return run_stage(spec, info, None, device="cpu", batch_size=2,
                     profile_dir=str(tmp_path / "prof"), log_cb=logs.append)


def test_a_failed_span_export_only_logs(tmp_path, monkeypatch):
    from lut_renderer_tpu_torch.engine import executor

    def broken(*args):
        raise RuntimeError("no kineto results")

    monkeypatch.setattr(executor, "write_spans", broken)
    logs = []
    res = _stage_with_profile(tmp_path, logs)
    assert res.ok, res.error
    assert res.stats.frames_out == 6
    assert (tmp_path / "prof" / "render_trace.json").exists()
    assert not (tmp_path / "prof" / "spans.jsonl").exists()
    assert any("spans not written: no kineto results" in m for m in logs)


def test_write_jsonl_refuses_a_trace_without_its_clock_base(tmp_path):
    _, prof = _profiled(lambda: [spans.span("x").__enter__().__exit__()])
    trace = tmp_path / "t.json"
    trace.write_text(json.dumps({"traceEvents": []}))
    with pytest.raises(ValueError, match="baseTimeNanoseconds"):
        spans.write_jsonl(tmp_path / "s.jsonl", prof, trace)
    assert not (tmp_path / "s.jsonl").exists()
