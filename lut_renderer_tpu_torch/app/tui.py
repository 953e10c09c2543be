"""Interactive terminal UI — the headless analog of the reference's MAIN
WINDOW loop (main_window.py:450-903, 1639-1744, 2557-2612), not just the
watch monitor: add files, edit every ProcessingParams field with inline
per-field help, pick LUTs from history, save/load presets, start (with the
re-apply-to-pending rule), reprocess, cancel, inspect.

Architecture mirrors app.monitor: ALL state transitions live in pure-ish
methods on InteractiveSession driven by single keypresses (cbreak) plus a
line-input buffer for text entry, and rendering is a pure function of the
session state — so the whole add -> configure -> start -> reprocess loop is
drivable headlessly (unit tests) and through a real pty (tests/test_tui.py).

    ┌ lut-tpu ── fast mode ── 2 tasks ── 37% ──────────────────────────┐
    │ > [1] clip_a.mp4      running   [████······]  41%                │
    │   [2] clip_b.mov      pending   [··········]   0%                │
    │ lut: teal_film.cube   out: ~/video/output                        │
    │ codec=prores_ks  bitrate=(source)  crf=-  interp=tetrahedral     │
    └ a:add e:edit l:lut p:presets m:mode s:start r:reprocess q:quit ──┘
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time
from pathlib import Path
from typing import Callable, List, Optional, TextIO

from ..models import ProcessingParams, Task, TaskStatus
from .defaults import mode_template
from .help import help_text
from .lut_history import lut_history, remember_lut
from .monitor import _STATUS_GLYPH, aggregate_progress, progress_bar
from .presets import (
    PresetExistsError,
    list_presets,
    load_preset,
    overwrite_preset,
    save_preset,
)
from .taskfactory import create_tasks

# Fields shown in the edit panel, in the reference's panel order (the ~40
# widgets of _build_ui); booleans toggle, everything else takes typed text
# (empty = auto, the reference convention).
EDIT_FIELDS: List[str] = [f.name for f in dataclasses.fields(ProcessingParams)
                          if not f.name.startswith("_")]
_BOOLS = ProcessingParams._BOOL_FIELDS


class InteractiveSession:
    """State machine for the interactive queue UI.

    modes: queue (default), edit (field list), input (line entry for the
    pending action), luts (history picker), presets (list picker),
    help (scrollable text)."""

    def __init__(self, manager, params: Optional[ProcessingParams] = None,
                 lut_path: Optional[Path] = None,
                 out_dir: Optional[Path] = None,
                 master_dir: Optional[Path] = None,
                 settings: Optional[dict] = None,
                 probe_fn=None):
        self.manager = manager
        self.params = params or mode_template("fast")
        self.lut_path = Path(lut_path) if lut_path else None
        self.out_dir = Path(out_dir) if out_dir else None
        self.master_dir = Path(master_dir) if master_dir else None
        self.settings = settings if settings is not None else {}
        self.probe_fn = probe_fn
        self.mode = "queue"
        self.note = ""
        self.sel = 0              # selected task row
        self.field_sel = 0        # selected edit field
        self.input_buf = ""
        self.input_target = ""    # what the pending line entry sets
        self.help_body: List[str] = []
        self.quit = threading.Event()

    # ------------------------------------------------------------------ tasks
    def tasks(self) -> List[Task]:
        return list(self.manager.tasks.values())

    def _selected_task(self) -> Optional[Task]:
        ts = self.tasks()
        if not ts:
            return None
        self.sel = max(0, min(self.sel, len(ts) - 1))
        return ts[self.sel]

    def add_paths(self, text: str) -> None:
        self.add_path_list([Path(p).expanduser() for p in text.split() if p])

    def add_path_list(self, paths) -> None:
        if not paths:
            self.note = "no paths given"
            return
        try:
            batch = create_tasks(paths, self.params, self.lut_path,
                                 self.out_dir, self.master_dir,
                                 probe_fn=self.probe_fn)
        except ValueError as exc:       # pro mode without master dir
            self.note = str(exc)
            return
        self.manager.add_tasks(batch.tasks)
        notes = []
        if batch.tasks:
            notes.append(f"added {len(batch.tasks)} task(s)")
        notes.extend(batch.warnings)     # keep warnings visible (disk etc.)
        if notes:
            self.note = " — ".join(notes)

    def start_all(self) -> None:
        """The reference's Start: re-snapshot the panel params onto every
        PENDING task (fresh smart defaults + naming), then dispatch
        (main_window.py:2557-2612)."""
        if self.lut_path:
            self.settings.update(remember_lut(self.lut_path, self.settings,
                                              persist=False))
        n = self.manager.apply_params_to_pending(
            self.params, lut_path=self.lut_path)
        self.manager.start_all()
        self.note = f"started (re-applied panel settings to {n} pending)"

    def reprocess_selected(self) -> None:
        task = self._selected_task()
        if task is None:
            self.note = "no task selected"
            return
        if task.status in (TaskStatus.PENDING, TaskStatus.RUNNING):
            self.note = f"{task.display_name()} is {task.status.value}"
            return
        # match apply_params_to_pending: a session LUT replaces the task's,
        # no session LUT PRESERVES it (clearing is explicit via the picker
        # then start, not an implicit side effect of reprocess)
        if self.lut_path is not None:
            task.lut_path = self.lut_path
        self.manager.reprocess_task(task.task_id, params=self.params)
        self.note = f"reprocessing {task.display_name()}"

    # ------------------------------------------------------------------ keys
    def on_key(self, key: str) -> None:
        if self.mode == "input":
            self._input_key(key)
        elif self.mode == "edit":
            self._edit_key(key)
        elif self.mode == "luts":
            self._luts_key(key)
        elif self.mode == "presets":
            self._presets_key(key)
        elif self.mode == "help":
            self.mode = "queue" if key in ("q", "?", "\x1b") else self.mode
        else:
            self._queue_key(key)

    def _begin_input(self, target: str, seed: str = "") -> None:
        self.mode = "input"
        self.input_target = target
        self.input_buf = seed

    def _queue_key(self, key: str) -> None:
        ts = self.tasks()
        if key == "q":
            self.quit.set()
        elif key == "a":
            self._begin_input("add")
        elif key == "e":
            self.mode = "edit"
            self.field_sel = 0
        elif key == "l":
            self.mode = "luts"
        elif key == "p":
            self.mode = "presets"
        elif key == "o":
            self._begin_input("out_dir", str(self.out_dir or ""))
        elif key == "M":
            self._begin_input("master_dir", str(self.master_dir or ""))
        elif key == "m":
            new = "pro" if self.params.processing_mode == "fast" else "fast"
            self.params = mode_template(new)
            self.note = (f"{new} mode template applied "
                         f"(codec={self.params.video_codec})")
        elif key == "s":
            self.start_all()
        elif key == "r":
            self.reprocess_selected()
        elif key == "c":
            task = self._selected_task()
            if task:
                self.manager.cancel_task(task.task_id)
                self.note = f"cancel requested: {task.display_name()}"
        elif key == "x":
            for t in ts:
                self.manager.cancel_task(t.task_id)
            self.note = "canceled all unfinished tasks"
        elif key == "i":
            task = self._selected_task()
            if task:
                self._show_info(task)
        elif key in ("j", "\x1b[B"):
            self.sel = min(self.sel + 1, max(0, len(ts) - 1))
        elif key in ("k", "\x1b[A"):
            self.sel = max(0, self.sel - 1)
        elif key.isdigit() and key != "0" and int(key) <= len(ts):
            self.sel = int(key) - 1
        elif key == "?":
            self.help_body = ("keys: a add · e edit params · l lut picker ·"
                             " p presets · m fast/pro · o out dir ·"
                             " M master dir · s start · r reprocess ·"
                             " c cancel row · x cancel all · i info ·"
                             " j/k select · q quit").split(" · ")
            self.mode = "help"

    def _input_key(self, key: str) -> None:
        if key in ("\r", "\n"):
            text = self.input_buf.strip()
            target, self.mode = self.input_target, "queue"
            if target == "add":
                self.add_paths(text)
            elif target == "out_dir":
                self.out_dir = Path(text).expanduser() if text else None
                self.note = f"out dir: {self.out_dir or '(per-source)'}"
            elif target == "master_dir":
                self.master_dir = Path(text).expanduser() if text else None
                self.note = f"master dir: {self.master_dir or '(unset)'}"
            elif target == "lut":
                self._set_lut(text)
            elif target == "preset_name":
                self._save_preset(text)
            elif target.startswith("field:"):
                self._set_field(target.split(":", 1)[1], text)
                self.mode = "edit"
        elif key == "\x1b":                       # esc cancels entry
            self.mode = ("edit" if self.input_target.startswith("field:")
                         else "queue")
            self.note = "canceled"
        elif key in ("\x7f", "\b"):
            self.input_buf = self.input_buf[:-1]
        elif key.isprintable():
            self.input_buf += key

    def _edit_key(self, key: str) -> None:
        fields = EDIT_FIELDS
        name = fields[self.field_sel]
        if key == "q" or key == "\x1b":
            self.mode = "queue"
        elif key in ("j", "\x1b[B"):
            self.field_sel = (self.field_sel + 1) % len(fields)
        elif key in ("k", "\x1b[A"):
            self.field_sel = (self.field_sel - 1) % len(fields)
        elif key == "?":
            text = help_text(name)
            self.help_body = text.splitlines()
            self.mode = "help"
        elif key in ("\r", "\n", "e"):
            if name in _BOOLS:
                setattr(self.params, name, not getattr(self.params, name))
                self.note = f"{name} = {getattr(self.params, name)}"
            else:
                self._begin_input(f"field:{name}",
                                  str(getattr(self.params, name)))

    def _set_field(self, name: str, value: str) -> None:
        if name in _BOOLS:
            setattr(self.params, name, value.lower() in
                    ("1", "true", "yes", "on"))
        else:
            setattr(self.params, name, value)
        self.note = f"{name} = {getattr(self.params, name)!r}"

    # ------------------------------------------------------------------ luts
    def _set_lut(self, text: str) -> None:
        if not text:
            self.lut_path = None
            self.note = "LUT cleared"
            return
        p = Path(text).expanduser()
        if not p.exists():
            self.note = f"no such LUT: {p}"
            return
        self.lut_path = p
        self.settings.update(remember_lut(p, self.settings, persist=False))
        self.note = f"LUT: {p.name}"

    def _luts_key(self, key: str) -> None:
        hist = lut_history(self.settings)
        if key in ("q", "\x1b"):
            self.mode = "queue"
        elif key == "n":
            self._begin_input("lut")
        elif key == "c":
            self.lut_path = None
            self.mode = "queue"
            self.note = "LUT cleared"
        elif key.isdigit() and key != "0" and int(key) <= len(hist):
            self.mode = "queue"
            self._set_lut(hist[int(key) - 1])

    # --------------------------------------------------------------- presets
    def _save_preset(self, name: str) -> None:
        if not name:
            self.note = "preset name required"
            return
        try:
            save_preset(name, self.params)
            self.note = f"preset saved: {name}"
        except PresetExistsError:
            overwrite_preset(name, self.params)
            self.note = f"preset overwritten: {name}"
        except Exception as exc:
            self.note = f"preset save failed: {exc}"

    def _presets_key(self, key: str) -> None:
        names = list_presets()
        if key in ("q", "\x1b"):
            self.mode = "queue"
        elif key == "s":
            self._begin_input("preset_name")
        elif key.isdigit() and key != "0" and int(key) <= len(names):
            name = names[int(key) - 1]
            try:
                self.params = load_preset(name)
                self.note = f"preset loaded: {name}"
            except Exception as exc:
                self.note = f"preset load failed: {exc}"
            self.mode = "queue"

    # ------------------------------------------------------------------ info
    def _show_info(self, task: Task) -> None:
        lines = [f"{task.display_name()}  [{task.status.value}]",
                 f"source: {task.source_path}",
                 f"output: {task.output_path}"]
        info = task.source_info
        if info:
            lines += [
                f"video:  {info.codec_name or '?'} {info.resolution or '?'} "
                f"{info.fps or '?'}fps {info.bit_depth or '?'}bit "
                f"{info.pix_fmt or ''}",
                f"color:  {info.colorspace or '-'} / "
                f"{info.color_primaries or '-'} / "
                f"range={info.color_range or '-'}",
                f"audio:  {info.audio_codec or '-'}",
            ]
        if task.error:
            lines.append(f"error:  {task.error}")
        self.help_body = lines
        self.mode = "help"

    # ---------------------------------------------------------------- render
    def render(self, width: int = 72) -> List[str]:
        if self.mode == "edit":
            return self._render_edit(width)
        if self.mode == "luts":
            return self._render_luts(width)
        if self.mode == "presets":
            return self._render_presets(width)
        if self.mode == "help":
            return self._render_help(width)
        return self._render_queue(width)

    def _box(self, head: str, body: List[str], foot: str,
             width: int) -> List[str]:
        lines = ["┌" + f" {head} ".ljust(width - 2, "─") + "┐"]
        for row in body:
            lines.append("│" + row.ljust(width - 2)[: width - 2] + "│")
        lines.append("└" + f" {foot} ".ljust(width - 2, "─") + "┘")
        if self.mode == "input":
            prompt = {"add": "add files/dirs", "lut": ".cube path",
                      "out_dir": "output dir", "master_dir": "master dir",
                      "preset_name": "preset name"}.get(
                self.input_target,
                self.input_target.replace("field:", "set "))
            lines.append(f" {prompt}> {self.input_buf}_")
        elif self.note:
            lines.append((" " + self.note)[:width])
        return lines

    def _render_queue(self, width: int) -> List[str]:
        ts = self.tasks()
        body = []
        name_w = max(10, width - 46)
        for i, task in enumerate(ts):
            name = task.display_name()
            if len(name) > name_w:
                name = name[: name_w - 1] + "…"
            mark = ">" if i == self.sel else " "
            status = _STATUS_GLYPH.get(task.status, str(task.status))
            body.append(f" {mark}[{i + 1}] {name.ljust(name_w)} {status} "
                        f"{progress_bar(task.progress)} {task.progress:3d}%")
        if not ts:
            body.append("  (queue empty — press a to add files)")
        body.append(f" lut: {self.lut_path.name if self.lut_path else '(none)'}"
                    f"   out: {self.out_dir or '(per-source)'}")
        p = self.params
        body.append(f" codec={p.video_codec} bitrate={p.bitrate or '(source)'}"
                    f" crf={p.crf or '-'} interp={p.lut_interp}"
                    f" depth={p.bit_depth_policy}")
        head = (f"lut-tpu ── {p.processing_mode} mode ── {len(ts)} tasks ── "
                f"{aggregate_progress(ts)}%")
        foot = ("a:add e:edit l:lut p:presets m:mode s:start r:reprocess "
                "c:cancel i:info q:quit ?:help")
        return self._box(head, body, foot, width)

    def _render_edit(self, width: int) -> List[str]:
        body = []
        for i, name in enumerate(EDIT_FIELDS):
            mark = ">" if i == self.field_sel else " "
            val = getattr(self.params, name)
            body.append(f" {mark} {name:<24} {val!r}")
        return self._box("edit parameters", body,
                         "j/k:move enter:edit ?:field help q:back", width)

    def _render_luts(self, width: int) -> List[str]:
        hist = lut_history(self.settings)
        body = [f" [{i + 1}] {p}" for i, p in enumerate(hist[:9])]
        if not body:
            body = ["  (no LUT history)"]
        cur = self.lut_path.name if self.lut_path else "(none)"
        body.append(f" current: {cur}")
        return self._box("LUT picker", body,
                         "1-9:select n:new path c:clear q:back", width)

    def _render_presets(self, width: int) -> List[str]:
        names = list_presets()
        body = [f" [{i + 1}] {n}" for i, n in enumerate(names[:9])]
        if not body:
            body = ["  (no presets saved)"]
        return self._box("presets", body, "1-9:load s:save-as q:back", width)

    def _render_help(self, width: int) -> List[str]:
        return self._box("info", [" " + l for l in self.help_body[:20]],
                         "q:back", width)


class InteractiveTui:
    """Wires InteractiveSession to a real terminal: cbreak key thread +
    ANSI in-place redraw (same machinery as monitor.QueueMonitor)."""

    def __init__(self, session: InteractiveSession,
                 stream: Optional[TextIO] = None, refresh_hz: float = 8.0,
                 width: int = 72,
                 input_fn: Optional[Callable[[], str]] = None):
        self.s = session
        self.stream = stream or sys.stdout
        self.interval = 1.0 / refresh_hz
        self.width = width
        self.input_fn = input_fn
        self._drawn = 0

    def _input_loop(self) -> None:
        from .termio import key_input_loop

        key_input_loop(self.s.on_key, self.s.quit, self.input_fn)

    def draw(self) -> None:
        lines = self.s.render(self.width)
        out = self.stream
        if self._drawn:
            out.write(f"\x1b[{self._drawn}F\x1b[J")
        out.write("\n".join(lines) + "\n")
        out.flush()
        self._drawn = len(lines)

    def run(self) -> None:
        t = threading.Thread(target=self._input_loop, daemon=True)
        t.start()
        try:
            while not self.s.quit.is_set():
                self.draw()
                time.sleep(self.interval)
            self.draw()
        finally:
            self.s.quit.set()
