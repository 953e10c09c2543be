"""Interactive terminal queue monitor — the headless analog of the
reference's live window: aggregate progress in the title bar
(main_window.py:331-371), per-row progress + cancel controls
(main_window.py:1979-2119), and a completion summary. PySide6 is not part of
this build (SURVEY.md §7.7), so the interactive surface is a terminal UI:

    ┌ lut-tpu queue ── 3 tasks ── 42% ─────────────────────┐
    │ [1] clip_a.mp4      running   [██████····]  61%      │
    │ [2] clip_b.mov      pending   [··········]   0%      │
    │ [3] clip_c.mp4      completed [██████████] 100%      │
    └ keys: 1-9 cancel task · a cancel all · q quit view ──┘

Key handling and frame rendering are pure functions over the manager's task
table so they are unit-testable without a tty; `watch_queue` wires them to a
real terminal (cbreak input thread + ANSI in-place redraw).
"""

from __future__ import annotations

import sys
import threading
import time
from typing import List, Optional, TextIO

from ..models import Task, TaskStatus

_STATUS_GLYPH = {
    TaskStatus.PENDING: "pending  ",
    TaskStatus.RUNNING: "running  ",
    TaskStatus.COMPLETED: "completed",
    TaskStatus.FAILED: "FAILED   ",
    TaskStatus.CANCELED: "canceled ",
}

BAR_CELLS = 10


def progress_bar(pct: int, cells: int = BAR_CELLS) -> str:
    filled = max(0, min(cells, pct * cells // 100))
    return "[" + "█" * filled + "·" * (cells - filled) + "]"


def aggregate_progress(tasks: List[Task]) -> int:
    """Mean progress across the queue — the reference's window-title /
    taskbar aggregation rule (main_window.py:331-371)."""
    if not tasks:
        return 0
    return sum(t.progress for t in tasks) // len(tasks)


def render_frame(tasks: List[Task], width: int = 72) -> List[str]:
    """Format one monitor frame as plain lines (no ANSI); pure."""
    name_w = max(10, width - 44)
    head = f" lut-tpu queue ── {len(tasks)} tasks ── {aggregate_progress(tasks)}% "
    lines = ["┌" + head.ljust(width - 2, "─") + "┐"]
    for i, task in enumerate(tasks):
        name = task.display_name()
        if len(name) > name_w:
            name = name[: name_w - 1] + "…"
        label = f"[{i + 1}]" if i < 9 else "   "
        status = _STATUS_GLYPH.get(task.status, str(task.status))
        row = (f" {label} {name.ljust(name_w)} {status} "
               f"{progress_bar(task.progress)} {task.progress:3d}% ")
        if task.status == TaskStatus.FAILED and task.error:
            row = row.rstrip() + " " + task.error[:18] + " "
        lines.append("│" + row.ljust(width - 2)[: width - 2] + "│")
    foot = " keys: 1-9 cancel task · a cancel all · q quit view "
    lines.append("└" + foot.ljust(width - 2, "─") + "┘")
    return lines


def handle_key(key: str, manager, tasks: List[Task]) -> Optional[str]:
    """Apply one keypress to the queue. Returns a status note (or "quit").

    Keys: "1".."9" cancel that row's task (PENDING/RUNNING only — the
    manager guard keeps finished tasks untouched); "a" cancels every
    unfinished task; "q" leaves the monitor (the queue keeps running)."""
    if key == "q":
        return "quit"
    if key == "a":
        for task in tasks:
            manager.cancel_task(task.task_id)
        return "canceled all unfinished tasks"
    if key.isdigit() and key != "0":
        idx = int(key) - 1
        if idx < len(tasks):
            task = tasks[idx]
            before = task.status
            manager.cancel_task(task.task_id)
            if before in (TaskStatus.PENDING, TaskStatus.RUNNING):
                return f"canceled [{idx + 1}] {task.display_name()}"
            return f"[{idx + 1}] already {before.value}"
    return None


class QueueMonitor:
    """Drives render_frame/handle_key against a live TaskManager.

    stream/input_fn are injectable for tests; the default input thread puts
    the tty in cbreak mode so single keys arrive without Enter."""

    def __init__(self, manager, stream: Optional[TextIO] = None,
                 refresh_hz: float = 8.0, width: int = 72):
        self.manager = manager
        self.stream = stream or sys.stdout
        self.interval = 1.0 / refresh_hz
        self.width = width
        self._note = ""
        self._quit = threading.Event()
        self._drawn_lines = 0

    # -- input ----------------------------------------------------------------
    def _input_loop(self) -> None:  # pragma: no cover - needs a real tty
        from .termio import key_input_loop

        key_input_loop(self.on_key, self._quit)

    def on_key(self, key: str) -> None:
        tasks = list(self.manager.tasks.values())
        note = handle_key(key, self.manager, tasks)
        if note == "quit":
            self._quit.set()
        elif note:
            self._note = note

    # -- output ---------------------------------------------------------------
    def draw(self) -> None:
        lines = render_frame(list(self.manager.tasks.values()), self.width)
        if self._note:
            lines.append((" " + self._note)[: self.width])
        out = self.stream
        if self._drawn_lines:
            out.write(f"\x1b[{self._drawn_lines}F\x1b[J")  # up + clear below
        out.write("\n".join(lines) + "\n")
        out.flush()
        self._drawn_lines = len(lines)

    def run(self, wait_fn=None) -> None:
        """Redraw until the queue drains, a key quits, or wait_fn returns.

        wait_fn: optional callable returning True when the queue is done
        (defaults to manager.wait_all with a zero timeout poll)."""
        use_tty = sys.stdin.isatty()
        t = None
        if use_tty:  # pragma: no cover - needs a real tty
            t = threading.Thread(target=self._input_loop, daemon=True)
            t.start()
        try:
            while not self._quit.is_set():
                self.draw()
                done = (wait_fn() if wait_fn
                        else self.manager.wait_all(timeout=self.interval))
                if done:
                    break
                if not wait_fn:
                    continue
                time.sleep(self.interval)
            self.draw()
        finally:
            self._quit.set()
