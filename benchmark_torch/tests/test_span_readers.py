"""The readers of the program's spans (``benchmark_torch/spans.py`` and
the metrics on it) on a synthetic trace plus spans: the means, the idle
time inside spans and its split, clipping to the window, None on an
anchor that disagrees with the window, None where there is nothing to
read; and a CPU run of a tiny cell through the harness."""

from __future__ import annotations

import pytest

from benchmark_torch import harness, spans, spec
from benchmark_torch.trace import Trace
from lut_renderer_tpu_torch import spans as program

from .conftest import REPO, run_tiny

OFF = 5e8            # us from the perf clock to the trace's
ANCHOR_NS = (100.0001e9, 100.0002e9)


def S(t):
    """Seconds of the synthetic perf clock -> ns."""
    return int(round(t * 1e9))


def U(t):
    """Seconds of the synthetic perf clock -> us on the trace's clock."""
    return t * 1e6 + OFF


def rec(name, t0, t1, id, parent=None, thread=7, **attrs):
    return program.Record(name, S(t0), S(t1), id, parent,
                          parent or id, thread, attrs)


# one job's loads and one call of the loop; (the seconds of the window
# [100, 101] that each covers)
RECORDS = [
    rec("runner.lut_load", 99.5, 99.6, 1, hit=True, size=65),  # before
    rec("runner.lut_load", 100.02, 100.1, 2, hit=False, size=65),
    rec("executor.run", 100.1, 100.9, 3, first_yield_ns=300_000_000),
    rec("executor.take", 100.1, 100.2, 4, 3, batch=0),
    rec("executor.stage", 100.2, 100.3, 5, 3, batch=0),
    rec("executor.render", 100.3, 100.35, 6, 3, batch=0),
    rec("executor.out", 100.35, 100.36, 7, 3, batch=0),
    rec("executor.wait", 100.36, 100.5, 8, 3, batch=0),
    # another thread's span is not the loop's
    rec("executor.stage", 100.0, 100.9, 9, thread=8),
]
# the card is busy over part of the stage, the render, out and wait, and
# the end of the window
BUSY = [(100.25, 100.5), (100.9, 101.0005)]


def fake_run(monkeypatch, records=RECORDS, anchor_shift_us=0.0,
             cell="fhd10_c65.dither8"):
    monkeypatch.setattr(program, "_records", list(records))
    monkeypatch.setattr(program, "_anchors", [ANCHOR_NS])
    c = spec.load_cell(cell, REPO)
    run = harness.Run(c, 1.0, 1.0, 8, [0], (1080, 1920), 65,
                      t0=100.0, t_close=101.0)
    a, b = ANCHOR_NS
    # the profiler put the anchor range in the middle of its two reads
    s, e = (a + 2e4) * 1e-3 + OFF, (b - 2e4) * 1e-3 + OFF
    run.trace = Trace(
        U(100.0), U(101.001), 1,
        device=[(0, U(x), U(y), "Memcpy HtoD (Pinned -> Device)")
                for x, y in BUSY],
        host=[(s + anchor_shift_us, e + anchor_shift_us, program.ANCHOR,
               1)])
    return run


def read(name, run):
    return spec.metric_reader(name)(run)


def test_means_of_the_window_spans(monkeypatch):
    run = fake_run(monkeypatch)
    # the other thread's stage counts in the mean: every stage span does
    assert read("stage_ms", run) == pytest.approx((100 + 900) / 2)
    assert read("render_call_ms", run) == pytest.approx(50)
    assert read("wait_ms", run) == pytest.approx(140)
    assert read("first_output_ms", run) == pytest.approx(300)
    # the load before the window (a hit) is not the window's
    assert read("lut_miss_ms", run) == pytest.approx(80)
    assert read("lut_hit_ms", run) is None
    assert read("lut_miss_pct", run) == pytest.approx(100)


def test_idle_inside_spans(monkeypatch):
    run = fake_run(monkeypatch)
    w = run.trace.window_s
    assert w == pytest.approx(1.001)
    assert read("idle_in_stage_pct", run) == pytest.approx(100 * 0.05 / w)
    assert read("idle_in_lut_load_pct", run) == pytest.approx(100 * 0.08 / w)
    # a span with no idle time in it reads 0, not None
    assert read("idle_in_render_pct", run) == 0.0


def test_the_split_adds_up_to_the_idle_time(monkeypatch):
    run = fake_run(monkeypatch)
    split = spans.idle_split(run)
    want = {"executor.take": 0.1, "executor.stage": 0.05,
            "executor.render": 0.0, "executor.out": 0.0,
            "executor.wait": 0.0, "runner.lut_load": 0.08,
            # the run's own: [100.5, 100.9]
            "executor.run": 0.4,
            # [100, 100.02] and [101.0005, 101.001]
            "no span": 0.0205}
    assert split == pytest.approx(want, abs=1e-9)
    idle = run.trace.window_s - run.trace.busy_s(run.cards)
    assert sum(split.values()) == pytest.approx(idle)
    assert 100 * idle / run.trace.window_s == pytest.approx(
        read("device_idle_pct", run))


def test_spans_are_clipped_to_the_window(monkeypatch):
    late = [rec("executor.run", 100.8, 101.3, 1),
            rec("executor.stage", 100.8, 101.3, 2, 1, batch=0),
            rec("executor.stage", 101.1, 101.2, 3, 1, batch=1)]
    run = fake_run(monkeypatch, late)
    run.trace.device = [(0, U(100.0), U(100.9), "k")]
    # idle inside the stage: [100.9, 101.0], not past the window's close
    assert read("idle_in_stage_pct", run) == pytest.approx(
        100 * 0.1 / run.trace.window_s)
    # the stage that started after the close is not the window's
    assert read("stage_ms", run) == pytest.approx(500)
    split = spans.idle_split(run)
    assert split["executor.stage"] == pytest.approx(0.1)
    assert split["no span"] == pytest.approx(0.001)


def test_an_anchor_that_disagrees_with_the_window_reads_none(monkeypatch):
    ok = fake_run(monkeypatch, anchor_shift_us=90.0)
    assert read("idle_in_stage_pct", ok) is not None
    run = fake_run(monkeypatch, anchor_shift_us=150.0)
    for name in ("idle_in_stage_pct", "idle_in_render_pct",
                 "idle_in_lut_load_pct"):
        assert read(name, run) is None
    assert spans.idle_split(run) is None
    # the host-clock means need no mapping
    assert read("stage_ms", run) is not None
    # an anchor of another recording
    monkeypatch.setattr(program, "_anchors", [ANCHOR_NS] * 2)
    assert spans.offset_us(run) is None


def test_none_where_there_is_nothing_to_read(monkeypatch):
    # a cell whose loads all hit: nothing for the misses
    hits = [r if r.name != "runner.lut_load" else
            r._replace(attrs={"hit": True, "size": 33}) for r in RECORDS]
    run = fake_run(monkeypatch, hits, cell="uhd8_c33.native")
    assert read("lut_miss_ms", run) is None
    assert read("lut_hit_ms", run) == pytest.approx(80)
    assert read("lut_miss_pct", run) == 0.0
    # no loop in the window
    run = fake_run(monkeypatch, RECORDS[:2])
    for name in ("stage_ms", "render_call_ms", "wait_ms", "first_output_ms",
                 "idle_in_stage_pct", "idle_in_render_pct"):
        assert read(name, run) is None
    assert read("idle_in_lut_load_pct", run) is None
    # no trace
    run = fake_run(monkeypatch)
    run.trace = None
    assert read("idle_in_stage_pct", run) is None
    assert read("stage_ms", run) is not None
    # a program that keeps no spans (the checkout before they were added)
    monkeypatch.setattr(spans, "_program", lambda: None)
    run = fake_run(monkeypatch)
    for name in ("stage_ms", "render_call_ms", "wait_ms", "first_output_ms",
                 "lut_hit_ms", "lut_miss_ms", "lut_miss_pct",
                 "idle_in_stage_pct", "idle_in_render_pct",
                 "idle_in_lut_load_pct"):
        assert read(name, run) is None


def test_a_traced_cpu_run_reads_the_host_clock_metrics(tiny):
    out = run_tiny(tiny, "t.dither", traced=True)
    assert out["correct"], out
    got = out["metrics"]
    for name in ("render_call_ms", "first_output_ms", "lut_miss_pct"):
        assert got[name]["value"] >= 0, name
    assert 0 < got["render_call_ms"]["value"] < 1e4
    # no pinned staging on the CPU, and no device trace for the shares
    for name in ("stage_ms", "wait_ms", "idle_in_stage_pct"):
        assert name not in got
