"""Task and TaskStatus: queue item data model.

Mirrors the reference contract (src/lut_renderer/models.py:11-16 for the 5-state
status enum; models.py:125-143 for Task fields including `intermediate_path`
used by the two-stage pro pipeline and start/finish timestamps).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path
from typing import Optional

from .params import ProcessingParams
from .video_info import VideoInfo


class TaskStatus(str, Enum):
    PENDING = "pending"
    RUNNING = "running"
    COMPLETED = "completed"
    FAILED = "failed"
    CANCELED = "canceled"


@dataclass
class Task:
    task_id: str
    source_path: Path
    output_path: Path
    lut_path: Optional[Path]
    cover_path: Optional[Path]
    params: ProcessingParams
    source_info: Optional[VideoInfo] = None
    intermediate_path: Optional[Path] = None
    status: TaskStatus = TaskStatus.PENDING
    progress: int = 0
    error: str = ""
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    metadata: dict = field(default_factory=dict)

    def display_name(self) -> str:
        return self.source_path.name
