"""Task creation: files + params -> queued Tasks.

Mirrors the reference's import flow `_add_paths` (main_window.py:1639-1744):
per file — probe, smart defaults (blank resolution/bitrate from source),
output/cover/intermediate naming, pro-mode ProRes size estimate with a
disk-space pre-flight warning, and the pro-mode requirement for an explicit
master cache dir (main_window.py:1645-1651).
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

from ..models import ProcessingParams, Task, VideoInfo
from .defaults import apply_smart_defaults
from .estimate import disk_space_warning, estimate_prores_bytes
from .naming import (
    collect_video_files,
    cover_path_for,
    default_output_dir,
    intermediate_path_for,
    output_path_for,
)


@dataclass
class TaskBatch:
    tasks: List[Task] = field(default_factory=list)
    logs: List[str] = field(default_factory=list)
    warnings: List[str] = field(default_factory=list)


def create_tasks(
    paths: List[Path],
    params: ProcessingParams,
    lut_path: Optional[Path] = None,
    out_dir: Optional[Path] = None,
    master_dir: Optional[Path] = None,
    probe_fn=None,
) -> TaskBatch:
    from ..hostio import probe_video

    probe = probe_fn or probe_video
    batch = TaskBatch()
    files = collect_video_files(paths)
    if not files:
        batch.warnings.append("no video files found in the given paths")
        return batch

    if params.processing_mode == "pro":
        if not master_dir:
            raise ValueError(
                "Pro mastering mode requires a master cache directory "
                "(set --master-dir)."
            )
        # the reference's dir comes from a picker so it always exists; the
        # headless analog creates it (out_dir gets the same treatment below)
        Path(master_dir).mkdir(parents=True, exist_ok=True)

    total_estimate = 0
    for src in files:
        info: Optional[VideoInfo] = None
        try:
            info = probe(src)
        except Exception as exc:
            batch.logs.append(f"{src.name}: probe failed ({exc}); using defaults")

        task_params = apply_smart_defaults(params, info, lut_active=lut_path is not None)
        dest_dir = Path(out_dir) if out_dir else default_output_dir(src)
        dest_dir.mkdir(parents=True, exist_ok=True)
        output = output_path_for(src, dest_dir)
        cover = (
            cover_path_for(src, dest_dir) if task_params.generate_cover else None
        )
        intermediate = None
        if task_params.processing_mode == "pro":
            intermediate = intermediate_path_for(src, Path(master_dir))
            est = estimate_prores_bytes(info)
            if est:
                total_estimate += est
                batch.logs.append(
                    f"{src.name}: estimated ProRes master ~{est / 1e9:.2f} GB"
                )

        batch.tasks.append(
            Task(
                task_id=str(uuid.uuid4()),
                source_path=src,
                output_path=output,
                lut_path=Path(lut_path) if lut_path else None,
                cover_path=cover,
                params=task_params,
                source_info=info,
                intermediate_path=intermediate,
            )
        )

    if total_estimate and master_dir:
        warning = disk_space_warning(total_estimate, Path(master_dir))
        if warning:
            batch.warnings.append(warning)
    return batch
