"""The traced run's timeline, read from ``torch.profiler`` (CUPTI).

The profiler records host operations (with the benchmark's own spans,
``bench::*`` annotations) and the device's kernels and copies on one
clock. ``Trace`` keeps what the per-layer readers need: device activity by
card and kind, host operations, and the window they are clipped to.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Iterable, List, Tuple

import numpy as np

WINDOW = "bench::window"


def copy_kind(name: str):
    """"HtoD", "DtoH", "PtoP", "DtoD" or "memset" for a copy or set on the
    device, None for a kernel."""
    if name.startswith("Memset"):
        return "memset"
    if name.startswith("Memcpy "):
        return name.split()[1]
    return None


@dataclass
class Trace:
    """Events in microseconds on the profiler's clock, clipped to the
    window [t0, t1]."""

    t0: float
    t1: float
    thread: int = 0   # the host thread that ran the window
    # (card, start, end, name) of every kernel, copy and set
    device: List[Tuple[int, float, float, str]] = field(default_factory=list)
    # (start, end, name, thread) of every host operation and span
    host: List[Tuple[float, float, str, int]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self, card: int) -> np.ndarray:
        """Merged (start, end) rows of the card's activity in the window."""
        spans = sorted((s, e) for c, s, e, _ in self.device if c == card)
        merged: List[List[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return np.asarray(merged, dtype=np.float64).reshape(-1, 2)

    def busy_s(self, cards: Iterable[int]) -> float:
        """Seconds with a kernel, copy or set running, averaged over cards."""
        cards = list(cards)
        total = sum(float(np.sum(iv[:, 1] - iv[:, 0]))
                    for iv in map(self.busy_intervals, cards))
        return total / len(cards) * 1e-6

    def device_ms(self, pick) -> Tuple[float, int]:
        """(total ms, count) of device events whose name `pick` accepts."""
        hits = [e - s for _, s, e, name in self.device if pick(name)]
        return sum(hits) * 1e-3, len(hits)

    def host_ms(self, names) -> float:
        """Total ms of host events with one of `names`."""
        return sum(e - s for s, e, name, _ in self.host
                   if name in names) * 1e-3

    def top_device_ops(self, k: int = 10) -> List[list]:
        """[name, seconds] of the device operations that took most time."""
        by = defaultdict(float)
        for _, s, e, name in self.device:
            by[name[:160]] += (e - s) * 1e-6
        return [[n, t] for n, t in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, cards: Iterable[int], k: int = 10,
                  longest: int = 400) -> List[list]:
        """[what the host was doing, seconds] of the device's idle time:
        the `longest` gaps of each card, each named by what the window's
        thread was running at its middle (the innermost benchmark span,
        then the outermost and the innermost host operation), summed by
        name."""
        host = [h for h in self.host if h[3] == self.thread]
        starts = np.array([h[0] for h in host])
        ends = np.array([h[1] for h in host])
        names = [h[2] for h in host]
        by = defaultdict(float)
        for card in cards:
            iv = self.busy_intervals(card)
            edges = np.concatenate([[self.t0], iv.ravel(), [self.t1]])
            gaps = edges.reshape(-1, 2)
            gaps = gaps[gaps[:, 1] > gaps[:, 0]]
            order = np.argsort(gaps[:, 0] - gaps[:, 1])[:longest]
            for s, e in gaps[order]:
                mid = (s + e) / 2
                inside = np.flatnonzero((starts <= mid) & (ends >= mid))
                inside = inside[np.argsort(starts[inside] - ends[inside])]
                spans = [names[i] for i in inside
                         if names[i].startswith("bench::")]
                ops = [names[i] for i in inside
                       if not names[i].startswith("bench::")]
                parts = spans[-1:] + ops[:1] + ops[-1:][:len(ops) - 1]
                by[" > ".join(parts) or "no host operation"] += (e - s) * 1e-6
        return [[n, t] for n, t in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def top_host_ops(self, k: int = 12) -> List[list]:
        """[name, seconds, count] of the window thread's host operations
        that took most time (nested operations count in each parent)."""
        by, count = defaultdict(float), defaultdict(int)
        for s, e, name, thread in self.host:
            if thread == self.thread and not name.startswith("bench::"):
                by[name] += (e - s) * 1e-6
                count[name] += 1
        top = sorted(by.items(), key=lambda x: -x[1])[:k]
        return [[n, t, count[n]] for n, t in top]


def _ns(ev, what: str) -> float:
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return float(fn())
    return float(getattr(ev, f"{what}_us")()) * 1e3


def from_profiler(prof) -> Trace:
    """The Trace of a stopped ``torch.profiler.profile`` whose window was
    annotated as ``bench::window``."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    raw = []
    window = None
    for ev in events:
        start = _ns(ev, "start") * 1e-3
        end = start + _ns(ev, "duration") * 1e-3
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            raw.append((True, int(ev.device_index()), start, end, name, 0))
        else:
            if name == WINDOW:
                window = (start, end, int(ev.start_thread_id()))
            raw.append((False, 0, start, end, name,
                        int(ev.start_thread_id())))
    if window is None:
        raise RuntimeError("the trace holds no bench::window span")
    t0, t1, thread = window
    tr = Trace(t0, t1, thread)
    for on_device, card, s, e, name, thread in raw:
        s, e = max(s, t0), min(e, t1)
        # the benchmark's spans also come back as device-side annotations
        # over the work they launched: they are not device work
        if e <= s or (on_device and name.startswith("bench::")) \
                or name == WINDOW:
            continue
        if on_device:
            tr.device.append((card, s, e, name))
        else:
            tr.host.append((s, e, name, thread))
    return tr
