"""The program's own spans (``lut_renderer_tpu_torch.spans``) in a run's
window, for the metrics that read them.

The program keeps its spans while a profiler records, so a traced run
holds the window's, on ``time.perf_counter_ns``: the clock of ``run.t0``
and ``run.t_close``, to which they are clipped. ``offset_us`` maps them
onto ``run.trace`` through the program's anchor ranges, and holds that
mapping to the pair (``run.t0``, ``trace.t0``) that the harness took as
the window opened. A program that keeps no spans, or a mapping that
disagrees, reads None, never 0.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

# most the anchor's mapping may differ from the window's own pair
AGREE_US = 100.0
RUN = "executor.run"


def _program():
    """The program's span module, or None where it has none."""
    try:
        from lut_renderer_tpu_torch import spans
    except ImportError:
        return None
    return spans


def window(run, name: str) -> Optional[list]:
    """The records called `name` that started in the window; None where
    the program keeps no spans."""
    prog = _program()
    if prog is None:
        return None
    t0, t1 = run.t0 * 1e9, run.t_close * 1e9
    return [r for r in prog.records()
            if r.name == name and t0 <= r.start_ns < t1]


def mean_ms(records: Optional[list]) -> Optional[float]:
    """Mean duration of `records` in ms; None for none."""
    if not records:
        return None
    return sum(r.end_ns - r.start_ns for r in records) / len(records) * 1e-6


def offset_us(run) -> Optional[float]:
    """Microseconds from perf_counter to ``run.trace``'s clock, by the
    program's anchor ranges in the trace; None without a trace or an
    anchor, or where it places ``run.t0`` more than AGREE_US from
    ``trace.t0``."""
    prog, tr = _program(), run.trace
    if prog is None or tr is None:
        return None
    ranges = sorted((s * 1e3, e * 1e3) for s, e, name, _ in tr.host
                    if name == prog.ANCHOR)
    found = prog.clock_offset_ns(ranges)
    if found is None:
        return None
    off = found[0] * 1e-3
    if abs(run.t0 * 1e6 + off - tr.t0) > AGREE_US:
        return None
    return off


def _merged(rows) -> np.ndarray:
    """The union of (start, end) rows as sorted disjoint rows."""
    out: List[List[float]] = []
    for s, e in sorted(rows):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return np.asarray(out, dtype=np.float64).reshape(-1, 2)


def _below(iv: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Measure of the disjoint rows `iv` below each time in `t`."""
    if not len(iv):
        return np.zeros_like(t)
    starts, lengths = iv[:, 0], iv[:, 1] - iv[:, 0]
    before = np.concatenate([[0.0], np.cumsum(lengths)])
    k = np.searchsorted(starts, t, side="right")
    last = np.maximum(k - 1, 0)
    part = np.where(k > 0, np.clip(t - starts[last], 0.0, lengths[last]),
                    0.0)
    return before[last] + part


def _overlap(a: np.ndarray, b: np.ndarray) -> float:
    """Measure of the intersection of two sets of disjoint rows."""
    if not len(a) or not len(b):
        return 0.0
    return float(np.sum(_below(a, b[:, 1]) - _below(a, b[:, 0])))


def _idle(tr, card: int) -> np.ndarray:
    """The card's idle rows in the trace's window."""
    edges = np.concatenate([[tr.t0], tr.busy_intervals(card).ravel(),
                            [tr.t1]])
    gaps = edges.reshape(-1, 2)
    return gaps[gaps[:, 1] > gaps[:, 0]]


def _loop_spans(run) -> Optional[list]:
    """(name, parent's name or None, start, end) on the trace's clock of
    the spans of the device loop's thread (the thread of the window's
    ``executor.run`` spans), clipped to the window. None without a
    mapping or without a call of the loop in the window."""
    off = offset_us(run)
    recs = _program().records() if off is not None else None
    if not recs:
        return None
    t0, t1 = run.t0 * 1e6, run.t_close * 1e6
    names = {r.id: r.name for r in recs}
    threads = {r.thread for r in recs if r.name == RUN
               and r.start_ns * 1e-3 < t1 and r.end_ns * 1e-3 > t0}
    out = []
    for r in recs:
        s, e = max(r.start_ns * 1e-3, t0), min(r.end_ns * 1e-3, t1)
        if r.thread in threads and e > s:
            out.append((r.name, names.get(r.parent), s + off, e + off))
    return out or None


def _rows(spans: list, pick) -> np.ndarray:
    return _merged([(s, e) for name, parent, s, e in spans
                    if pick(name, parent)])


def idle_split(run) -> Optional[Dict[str, float]]:
    """Seconds of device idle, averaged over the cards, put down to the
    span the loop's thread was in: an inner span (one with a parent, a
    step of the loop) by its name; an outer span by its name for the
    moments none of its inner spans covers; and "no span" for what no span
    covers. They add up to the window's idle seconds. None where the spans
    cannot be read."""
    spans, tr = _loop_spans(run), run.trace
    if spans is None:
        return None
    inner = sorted({n for n, p, _, _ in spans if p is not None})
    outer = sorted({n for n, p, _, _ in spans if p is None})
    rows = {n: _rows(spans, lambda name, _, n=n: name == n)
            for n in inner + outer}
    kids = {n: _rows(spans, lambda _, parent, n=n: parent == n)
            for n in outer}
    roots = _rows(spans, lambda _, parent: parent is None)
    out = dict.fromkeys(inner + outer + ["no span"], 0.0)
    for card in run.cards:
        idle = _idle(tr, card)
        for n in inner:
            out[n] += _overlap(idle, rows[n])
        for n in outer:
            out[n] += _overlap(idle, rows[n]) - _overlap(idle, kids[n])
        out["no span"] += (float(np.sum(idle[:, 1] - idle[:, 0]))
                           - _overlap(idle, roots))
    return {k: v / len(run.cards) * 1e-6 for k, v in out.items()}


def idle_in_pct(run, name: str) -> Optional[float]:
    """Device idle inside the loop thread's `name` spans, averaged over
    the cards, as a share of the window in percent; None where the spans
    cannot be read or the window has none called `name`."""
    spans, tr = _loop_spans(run), run.trace
    if spans is None or tr.window_s <= 0:
        return None
    rows = _rows(spans, lambda n, _: n == name)
    if not len(rows):
        return None
    idle = sum(_overlap(_idle(tr, c), rows) for c in run.cards)
    return 100.0 * idle / len(run.cards) * 1e-6 / tr.window_s
