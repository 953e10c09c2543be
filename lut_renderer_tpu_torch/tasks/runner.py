"""TaskRunner: executes one Task's render stages on a worker thread.

The port's counterpart of lut_renderer_tpu/tasks/runner.py, with the same
contract (stage loop, 50/50 progress split for two stages, cooperative
cancel, cover extraction, cleanup of the pro master on every outcome). It
calls the port's run_stage on an explicit device, and loads each .cube as
a LutTable on that device instead of the JAX package's prepared tiers.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Dict, Tuple

from ..hostio import probe_video
from ..models import Task, TaskStatus
from ..plan import build_pipeline, build_render_spec

from ..engine.executor import run_stage
from ..ops.prepare import LutTable
from ..spans import span
from .signals import Signal

_LUT_CACHE: Dict[Tuple[str, int, str], LutTable] = {}
_LUT_CACHE_LOCK = threading.Lock()
# a warm daemon switching between a handful of looks shouldn't re-parse
# and re-upload the table on every task
_LUT_CACHE_MAX = 4
# loads served from the cache, loads that parsed and uploaded, and tables
# the LRU let go, since the process started (the server's status reply)
lut_hits = 0
lut_misses = 0
lut_evictions = 0


def load_lut_table(path: Path, device) -> LutTable:
    """Parse a .cube and upload it to `device`, cached by (path, mtime,
    device); small LRU. One span, ``runner.lut_load``, with attributes
    ``hit`` and ``size``."""
    global lut_hits, lut_misses, lut_evictions
    from ..colorcore import parse_cube_file

    with span("runner.lut_load") as sp:
        path = Path(path)
        key = (str(path.resolve()), path.stat().st_mtime_ns, str(device))
        with _LUT_CACHE_LOCK:
            lut = _LUT_CACHE.pop(key, None)
            hit = lut is not None
            if hit:
                lut_hits += 1
            else:
                lut_misses += 1
                lut = LutTable.from_lut3d(parse_cube_file(path), device)
                while len(_LUT_CACHE) >= _LUT_CACHE_MAX:
                    _LUT_CACHE.pop(next(iter(_LUT_CACHE)))
                    lut_evictions += 1
            _LUT_CACHE[key] = lut  # (re-)insert at MRU position
        sp.attrs.update(hit=hit, size=lut.size)
    return lut


def lut_cache_stats() -> dict:
    """The LUT cache's counters and the tables it holds."""
    with _LUT_CACHE_LOCK:
        return {"hits": lut_hits, "misses": lut_misses,
                "evictions": lut_evictions, "entries": len(_LUT_CACHE)}


def extract_cover(source: Path, dest: Path) -> None:
    """First frame of `source` -> JPEG at `dest` (reference cover semantics:
    -frames:v 1 -q:v 2, task_manager.py:195-216)."""
    import cv2

    cap = cv2.VideoCapture(str(source))
    try:
        ok, frame = cap.read()
        if not ok or frame is None:
            raise RuntimeError(f"no frame decodable from {source}")
        if not cv2.imwrite(str(dest), frame, [cv2.IMWRITE_JPEG_QUALITY, 95]):
            raise RuntimeError(f"failed writing {dest}")
    finally:
        cap.release()


class TaskRunner:
    def __init__(self, task: Task, lut_strategy: str = "mxu",
                 profile_dir=None, device="cuda"):
        self.task = task
        self.lut_strategy = lut_strategy
        self.profile_dir = profile_dir
        self.device = device
        self.progress = Signal("progress")     # (task_id, int)
        self.status = Signal("status")         # (task_id, str)
        self.finished = Signal("finished")     # (task_id, str)
        self.log = Signal("log")               # (task_id, str)
        self._cancel = threading.Event()

    def cancel(self) -> None:
        self._cancel.set()

    # -----------------------------------------------------------------------
    def run(self) -> None:
        task = self.task
        self.status.emit(task.task_id, TaskStatus.RUNNING.value)
        self._log("started")
        task.started_at = time.time()
        stages = []

        try:
            stages = build_pipeline(task)
            if not stages:
                raise RuntimeError("no render stages built")

            for index, stage in enumerate(stages):
                if self._cancel.is_set():
                    break
                self._log(f"stage {index + 1}/{len(stages)}: {stage.name}")

                stage_info = task.source_info
                if stage.probe_source:
                    try:
                        stage_info = probe_video(stage.source_path)
                    except Exception as exc:
                        stage_info = None
                        self._log(
                            f"note: stage input probe failed (treating as "
                            f"unknown source): {exc}"
                        )

                spec = build_render_spec(
                    source=stage.source_path,
                    output=stage.output_path,
                    params=stage.params,
                    lut_path=stage.lut_path,
                    source_info=stage_info,
                    notes=stage.notes,
                )
                for note in stage.notes:
                    self._log(note)

                lut = None
                if spec.lut_path is not None:
                    lut = load_lut_table(spec.lut_path, self.device)
                    self._log(
                        f"LUT loaded: size {lut.size}^3"
                        + ("" if lut.has_unit_domain else " (non-unit domain)")
                    )

                progress_base = 0
                progress_span = 100
                if len(stages) > 1:
                    progress_span = 100 // len(stages)
                    progress_base = progress_span * index
                is_final = index == len(stages) - 1

                def stage_progress(p: int, base=progress_base,
                                   span=progress_span, final=is_final):
                    sp = int(p * span / 100)
                    if not final:
                        sp = min(sp, max(0, span - 1))
                    self.progress.emit(
                        task.task_id, min(base + sp, 100 if final else 99)
                    )

                result = run_stage(
                    spec,
                    stage_info,
                    lut,
                    progress_cb=stage_progress,
                    log_cb=lambda m: self._log(m),
                    cancel=self._cancel,
                    device=self.device,
                    lut_strategy=self.lut_strategy,
                    profile_dir=self.profile_dir,
                )
                # per-stage throughput counters reach the task log on
                # every outcome
                if result.stats.frames_out or result.stats.frames_in:
                    self._log(f"stage {index + 1} stats: "
                              f"{result.stats.summary()}")
                if result.canceled:
                    break
                if not result.ok:
                    self.status.emit(
                        task.task_id, f"{TaskStatus.FAILED.value}: {result.error}"
                    )
                    self._log(f"failed: {result.error}")
                    self._cleanup_intermediates(stages, failed=True)
                    self.finished.emit(task.task_id, TaskStatus.FAILED.value)
                    return

            if self._cancel.is_set():
                self._cleanup_intermediates(stages, failed=True)
                self.status.emit(task.task_id, TaskStatus.CANCELED.value)
                self._log("canceled")
                self.finished.emit(task.task_id, TaskStatus.CANCELED.value)
                return

            if task.cover_path:
                self._log("extracting cover frame")
                src = (
                    task.output_path
                    if task.output_path.exists()
                    else task.source_path
                )
                try:
                    extract_cover(src, task.cover_path)
                    self._log(f"cover saved: {task.cover_path}")
                except Exception as exc:
                    self._log(f"cover extraction failed: {exc}")

            self._cleanup_intermediates(stages, failed=False)
            self.progress.emit(task.task_id, 100)
            self.status.emit(task.task_id, TaskStatus.COMPLETED.value)
            self._log(f"completed in {time.time() - task.started_at:.1f}s")
            self.finished.emit(task.task_id, TaskStatus.COMPLETED.value)

        except Exception as exc:
            self.status.emit(task.task_id, f"{TaskStatus.FAILED.value}: {exc}")
            self._log(f"failed: {exc}")
            # keep the no-leaked-master promise on failures outside run_stage
            self._cleanup_intermediates(stages, failed=True)
            self.finished.emit(task.task_id, TaskStatus.FAILED.value)

    def _cleanup_intermediates(self, stages, failed: bool) -> None:
        for stage in stages:
            if stage.cleanup_on_success and Path(stage.output_path).exists():
                try:
                    Path(stage.output_path).unlink()
                    if failed:
                        self._log(f"removed intermediate: {stage.output_path}")
                except Exception:
                    pass

    def _log(self, message: str) -> None:
        self.log.emit(self.task.task_id, message)
