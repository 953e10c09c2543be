"""TaskManager: the queue with concurrency control.

Reference contract (src/lut_renderer/task_manager.py:219-315): signals
task_added / task_updated / task_progress / queue_finished / task_log;
methods add_task(s) / start_all / cancel_task / clear_completed /
remove_task / set_max_concurrency; status bookkeeping identical (FAILED
status strings carry the error suffix; queue_finished fires when the last
runner drains).

Concurrency is a dispatcher over plain threads instead of QThreadPool:
start_all snapshots PENDING tasks into a dispatch deque; at most
`max_concurrency` runner threads are live (default 1, like the reference's
main window; the class default there is 2 but the UI passes 1 —
main_window.py:210).

The port's copy of lut_renderer_tpu/tasks/manager.py: that module builds
the JAX TaskRunner, and importing it loads jax. This one builds the port's
TaskRunner, with the render device in place of the LUT strategy's
platform choice."""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from ..models import Task, TaskStatus

from .runner import TaskRunner
from .signals import Signal


class TaskManager:
    def __init__(self, max_concurrency: int = 1, lut_strategy: str = "mxu",
                 profile_dir=None, device="cuda"):
        self.task_added = Signal("task_added")        # (task_id)
        self.task_updated = Signal("task_updated")    # (task_id)
        self.task_progress = Signal("task_progress")  # (task_id, int)
        self.queue_finished = Signal("queue_finished")  # ()
        self.task_log = Signal("task_log")            # (task_id, str)

        self.tasks: Dict[str, Task] = {}
        self.runners: Dict[str, TaskRunner] = {}
        self._threads: Dict[str, threading.Thread] = {}
        self._pending: deque = deque()
        self._lock = threading.RLock()
        self._max = max(1, max_concurrency)
        self._lut_strategy = lut_strategy
        self._profile_dir = profile_dir
        self._device = device

    # -- queue management ---------------------------------------------------
    @property
    def max_concurrency(self) -> int:
        return self._max

    def set_max_concurrency(self, value: int) -> None:
        with self._lock:
            self._max = max(1, int(value))
        self._dispatch()

    def add_task(self, task: Task) -> None:
        with self._lock:
            self.tasks[task.task_id] = task
        self.task_added.emit(task.task_id)

    def add_tasks(self, tasks: List[Task]) -> None:
        for task in tasks:
            self.add_task(task)

    def start_all(self) -> None:
        with self._lock:
            for task_id, task in list(self.tasks.items()):
                if task.status != TaskStatus.PENDING:
                    continue
                if task_id in self.runners or task_id in self._pending:
                    continue
                self._pending.append(task_id)
        self._dispatch()

    def _dispatch(self) -> None:
        to_start = []
        with self._lock:
            while self._pending and len(self.runners) < self._max:
                task_id = self._pending.popleft()
                task = self.tasks.get(task_id)
                if task is None or task.status != TaskStatus.PENDING:
                    continue
                runner = TaskRunner(task, lut_strategy=self._lut_strategy,
                                    profile_dir=self._profile_dir,
                                    device=self._device)
                runner.progress.connect(self._on_progress)
                runner.status.connect(self._on_status)
                runner.finished.connect(self._on_finished)
                runner.log.connect(self._on_log)
                self.runners[task_id] = runner
                task.status = TaskStatus.RUNNING
                to_start.append((task_id, runner))
        for task_id, runner in to_start:
            self.task_updated.emit(task_id)
            thread = threading.Thread(
                target=runner.run, name=f"task-{task_id[:8]}", daemon=True
            )
            self._threads[task_id] = thread
            thread.start()

    # -- task control -------------------------------------------------------
    def cancel_task(self, task_id: str) -> None:
        """Cancel a PENDING or RUNNING task. Finished tasks (COMPLETED /
        FAILED / CANCELED) are left untouched so a queue-wide cancel (e.g.
        the CLI's Ctrl-C loop) never rewrites completed work as canceled."""
        with self._lock:
            runner = self.runners.get(task_id)
            if task_id in self._pending:
                self._pending.remove(task_id)
        task = self.tasks.get(task_id)
        if task is None or task.status not in (
            TaskStatus.PENDING, TaskStatus.RUNNING
        ):
            return
        if runner:
            runner.cancel()
        task.status = TaskStatus.CANCELED
        self.task_updated.emit(task_id)

    def clear_completed(self) -> None:
        done = {TaskStatus.COMPLETED, TaskStatus.FAILED, TaskStatus.CANCELED}
        with self._lock:
            remove = [tid for tid, t in self.tasks.items() if t.status in done]
            for tid in remove:
                self.tasks.pop(tid, None)
                self.runners.pop(tid, None)
                self._threads.pop(tid, None)
        for tid in remove:
            self.task_updated.emit(tid)

    def remove_task(self, task_id: str) -> None:
        with self._lock:
            runner = self.runners.get(task_id)
            if task_id in self._pending:
                self._pending.remove(task_id)
        if runner:
            runner.cancel()
        with self._lock:
            self.runners.pop(task_id, None)
            self._threads.pop(task_id, None)
            existed = self.tasks.pop(task_id, None) is not None
        if existed:
            self.task_updated.emit(task_id)

    def wait_all(self, timeout: Optional[float] = None) -> bool:
        """Block until the queue drains (CLI convenience; not in reference)."""
        deadline = time.time() + timeout if timeout else None
        while True:
            with self._lock:
                threads = list(self._threads.values())
                idle = not self.runners and not self._pending
            if idle and not any(t.is_alive() for t in threads):
                return True
            if deadline and time.time() > deadline:
                return False
            time.sleep(0.05)

    def reprocess_task(self, task_id: str, params=None,
                       new_output_path=None) -> bool:
        """Re-enqueue a finished/failed task with fresh parameters and a new
        output path (reference: main_window.py:1863-1930 _reprocess_selected:
        re-snapshot params, fresh output name, status -> PENDING, reset row)."""
        task = self.tasks.get(task_id)
        if task is None or task.status == TaskStatus.RUNNING:
            return False
        if params is not None:
            task.params = params
        if new_output_path is not None:
            task.output_path = new_output_path
        else:
            from ..app.naming import output_path_for

            task.output_path = output_path_for(
                task.source_path, task.output_path.parent
            )
        task.status = TaskStatus.PENDING
        task.progress = 0
        task.error = ""
        task.started_at = None
        task.finished_at = None
        self.task_updated.emit(task_id)
        return True

    def apply_params_to_pending(self, params, lut_path=None,
                                regenerate_output: bool = True) -> int:
        """Re-snapshot `params` onto every PENDING task before a start —
        the reference re-applies the current panel settings to all pending
        tasks when Start is pressed (main_window.py:2557-2612): smart
        defaults re-run per source (blank resolution/bitrate from probe),
        the copy-codec+LUT guard re-applied, and fresh non-colliding output
        paths generated. Returns the number of tasks updated."""
        from ..app.defaults import apply_smart_defaults
        from ..app.naming import cover_path_for, output_path_for

        updated = []
        with self._lock:
            pending = [t for t in self.tasks.values()
                       if t.status == TaskStatus.PENDING]
        for task in pending:
            if lut_path is not None:
                task.lut_path = lut_path
            task.params = apply_smart_defaults(
                params, task.source_info, lut_active=task.lut_path is not None
            )
            out_dir = task.output_path.parent
            if regenerate_output:
                task.output_path = output_path_for(task.source_path, out_dir)
            task.cover_path = (
                cover_path_for(task.source_path, out_dir)
                if task.params.generate_cover else None
            )
            if task.params.processing_mode == "pro" and task.intermediate_path:
                from ..app.naming import intermediate_path_for

                task.intermediate_path = intermediate_path_for(
                    task.source_path, task.intermediate_path.parent
                )
            elif task.params.processing_mode != "pro":
                task.intermediate_path = None
            updated.append(task.task_id)
        for task_id in updated:
            self.task_updated.emit(task_id)
        return len(updated)

    # -- queue persistence (checkpoint/resume; absent in the reference whose
    # in-memory queue dies with the app — SURVEY.md §5.4 marks this the one
    # cheap recovery affordance worth adding) --------------------------------
    def save_queue(self, path) -> None:
        import json
        from pathlib import Path as _P

        with self._lock:
            items = []
            for task in self.tasks.values():
                items.append({
                    "task_id": task.task_id,
                    "source_path": str(task.source_path),
                    "output_path": str(task.output_path),
                    "lut_path": str(task.lut_path) if task.lut_path else None,
                    "cover_path": str(task.cover_path) if task.cover_path else None,
                    "intermediate_path": (
                        str(task.intermediate_path)
                        if task.intermediate_path else None
                    ),
                    "params": task.params.to_dict(),
                    "status": task.status.value,
                    "progress": task.progress,
                    "error": task.error,
                })
        # atomic: a crash mid-write must never corrupt the recovery file
        target = _P(path)
        tmp = target.with_name(target.name + ".tmp")
        tmp.write_text(
            json.dumps({"version": 1, "tasks": items}, indent=2),
            encoding="utf-8",
        )
        os.replace(tmp, target)

    def load_queue(self, path, probe: bool = True) -> int:
        """Restore tasks from a saved queue file. RUNNING entries come back
        as PENDING (they were interrupted); COMPLETED/FAILED/CANCELED keep
        their status for display. Returns the number of tasks loaded."""
        import json
        from pathlib import Path as _P

        from ..models import ProcessingParams

        data = json.loads(_P(path).read_text(encoding="utf-8"))
        count = 0
        for item in data.get("tasks", []):
            status = item.get("status", "pending")
            if status == TaskStatus.RUNNING.value:
                status = TaskStatus.PENDING.value
            info = None
            src = _P(item["source_path"])
            if probe and src.exists():
                try:
                    from ..hostio import probe_video

                    info = probe_video(src)
                except Exception:
                    info = None
            task = Task(
                task_id=item["task_id"],
                source_path=src,
                output_path=_P(item["output_path"]),
                lut_path=_P(item["lut_path"]) if item.get("lut_path") else None,
                cover_path=_P(item["cover_path"]) if item.get("cover_path") else None,
                params=ProcessingParams.from_dict(item.get("params", {})),
                source_info=info,
                intermediate_path=(
                    _P(item["intermediate_path"])
                    if item.get("intermediate_path") else None
                ),
                status=TaskStatus(status),
                progress=int(item.get("progress", 0)),
                error=item.get("error", ""),
            )
            self.add_task(task)
            count += 1
        return count

    # -- runner callbacks ---------------------------------------------------
    def _on_progress(self, task_id: str, progress: int) -> None:
        task = self.tasks.get(task_id)
        if not task:
            return
        task.progress = progress
        self.task_progress.emit(task_id, progress)

    def _on_status(self, task_id: str, status: str) -> None:
        task = self.tasks.get(task_id)
        if not task:
            return
        if status.startswith(TaskStatus.FAILED.value):
            task.status = TaskStatus.FAILED
            task.error = status
        elif status in TaskStatus._value2member_map_:
            task.status = TaskStatus(status)
        self.task_updated.emit(task_id)

    def _on_finished(self, task_id: str, status: str) -> None:
        task = self.tasks.get(task_id)
        if task:
            task.finished_at = time.time()
        with self._lock:
            self.runners.pop(task_id, None)
            any_left = bool(self.runners) or bool(self._pending)
        self._dispatch()
        with self._lock:
            any_left = bool(self.runners) or bool(self._pending)
        if not any_left:
            self.queue_finished.emit()

    def _on_log(self, task_id: str, message: str) -> None:
        self.task_log.emit(task_id, message)
