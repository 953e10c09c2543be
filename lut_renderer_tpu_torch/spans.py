"""Spans of the device loop and the LUT cache, kept while a profiler records.

``span(name, parent=None, **attrs)`` times a block with two
``time.perf_counter_ns`` reads, always: ``StageStats`` sums its
``seconds``. While a ``torch.profiler`` profile records (the CLI's
``--profile DIR``, the benchmark's traced run) it also keeps a
``Record``: name, start and end (perf_counter ns), its id, its parent's
id, its call (the id of the outermost span it descends from), the native
thread id and the attributes. Nothing else turns recording on. A
recording begins at the first span that finds a profiler running after a
span found none (or at ``begin``), and its records stay readable until
the next one begins.

A span opens no ``record_function`` range: one costs about 11 us even
with no profiler running (on an H100 machine's host), and CUPTI hands it
back as a device-side range over the kernels it launched, which would
count as device activity. Instead, when recording turns on, ``ANCHORS``
empty ``lut_renderer::clock`` ranges, each between two
``perf_counter_ns`` reads, tie the records to the profiler's clock
(``clock_offset_ns``); they launch nothing.
"""

from __future__ import annotations

import itertools
import json
import os
import re
import threading
import time
from pathlib import Path
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.autograd.profiler as _profiler

ANCHOR = "lut_renderer::clock"
# the first range of a profile pays the profiler's first-event cost; the
# later ones bracket its clock to a few microseconds
ANCHORS = 3
# records kept a recording (about 1M); past it they are counted as dropped
CAP = 1 << 20

_now = time.perf_counter_ns
_ids = itertools.count(1)
_lock = threading.Lock()
_on = False
_records: list = []
_anchors: List[Tuple[int, int]] = []
_dropped = 0
_thread = threading.local()


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    call: int
    thread: int
    attrs: dict


def _turn_on(force: bool = False) -> None:
    """A new recording: empty the buffer and anchor it to the profiler."""
    global _on, _dropped
    with _lock:
        if _on and not force:
            return
        _records.clear()
        _anchors.clear()
        _dropped = 0
        for _ in range(ANCHORS):
            before = _now()
            with torch.profiler.record_function(ANCHOR):
                pass
            _anchors.append((before, _now()))
        _on = True


def _thread_id() -> int:
    """The native id of this thread, asked of the system once a thread."""
    try:
        return _thread.id
    except AttributeError:
        _thread.id = threading.get_native_id()
        return _thread.id


def begin() -> None:
    """Start a new recording now, under a running profiler. The first span
    to find a profiler after a span found none does the same; a caller
    that starts the profiler itself calls this, since no span of its own
    may have run between two profiles."""
    _turn_on(force=True)


class span:
    """Times a block; records it while a profiler records. `parent` is an
    enclosing span, named explicitly so a generator can hold one open
    across its yields."""

    __slots__ = ("name", "parent", "attrs", "id", "call", "start", "end")

    def __init__(self, name: str, parent: Optional["span"] = None, **attrs):
        self.name, self.parent, self.attrs = name, parent, attrs
        self.id = None

    def __enter__(self) -> "span":
        global _on
        if _profiler._is_profiler_enabled:
            if not _on:
                _turn_on()
            self.id = next(_ids)
            parent = self.parent
            self.call = (parent.call if parent is not None
                         and parent.id is not None else self.id)
        elif _on:
            _on = False
        self.start = _now()
        return self

    def __exit__(self, *exc) -> bool:
        global _dropped
        self.end = _now()
        if self.id is not None:
            if len(_records) < CAP:
                parent = self.parent
                _records.append((
                    self.name, self.start, self.end, self.id,
                    parent.id if parent is not None else None, self.call,
                    _thread_id(), self.attrs))
            else:
                with _lock:
                    _dropped += 1
        return False

    @property
    def recording(self) -> bool:
        """The span is being kept: a profiler recorded as it opened."""
        return self.id is not None

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9

    def mark(self, key: str) -> None:
        """Set attribute `key`, once, to the ns since the span started."""
        if key not in self.attrs:
            self.attrs[key] = _now() - self.start


def records() -> List[Record]:
    """The spans of the latest recording, in the order they closed."""
    return [Record(*r) for r in _records]


def dropped() -> int:
    """Spans the latest recording left out past ``CAP``."""
    return _dropped


def clock_offset_ns(ranges: Sequence[Tuple[float, float]]
                    ) -> Optional[Tuple[int, int]]:
    """(offset, half-width) in ns from perf_counter to the profiler's
    clock, from the (start, end) of the anchor ranges as the profiler
    recorded them, in order: each range lies between its two reads, so the
    offset lies in [end - after, start - before] of every one. None where
    they are not the latest recording's or disagree."""
    if not _anchors or len(ranges) != len(_anchors):
        return None
    lo = max(e - after for (_, e), (_, after) in zip(ranges, _anchors))
    hi = min(s - before for (s, _), (before, _) in zip(ranges, _anchors))
    if lo > hi:
        return None
    return int((lo + hi) // 2), int((hi - lo) // 2)


def write_jsonl(path: Path, prof, chrome_trace: Path) -> int:
    """Write the latest recording beside a stopped profile `prof` as
    chrome trace events ("ts" and "dur" in microseconds), one a line, on
    the clock of `chrome_trace`, the profile's ``export_chrome_trace``
    file. The first line gives the count and the dropped count. Returns
    the spans written: none, and no file, where the profile recorded
    none. Raises ValueError, and writes nothing, where the trace file
    gives no clock base."""
    ranges = sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns())
                    for ev in prof.profiler.kineto_results.events()
                    if ev.name() == ANCHOR)
    found = clock_offset_ns(ranges)
    if found is None:
        return 0
    offset, half = found
    # the file's "ts" is its events' ns since this base, over 1000
    with open(chrome_trace, "rb") as f:
        head = re.search(rb'"baseTimeNanoseconds":\s*(\d+)', f.read(1 << 16))
    if head is None:
        raise ValueError(f"no baseTimeNanoseconds in {chrome_trace}")
    base = int(head.group(1))
    recs = records()
    with open(path, "w") as f:
        f.write(json.dumps({"ph": "M", "name": "lut_renderer_spans", "args": {
            "spans": len(recs), "dropped": dropped(),
            "clock_half_width_us": half / 1e3}}) + "\n")
        pid = os.getpid()
        for r in recs:
            f.write(json.dumps({
                "ph": "X", "cat": "lut_renderer", "name": r.name,
                "ts": (r.start_ns + offset - base) / 1e3,
                "dur": (r.end_ns - r.start_ns) / 1e3, "pid": pid,
                "tid": r.thread,
                "args": {"id": r.id, "parent": r.parent, "call": r.call,
                         **r.attrs}}) + "\n")
    return len(recs)
