"""ProRes master disk-space estimation.

Reference planning rule (main_window.py:1796-1806, readme.md:69): ProRes
422 HQ is budgeted at 220 Mbps for 1080p30, scaled by pixel rate
w*h*fps / (1920*1080*29.97) with a 0.1x floor; pro-mode imports warn when the
estimate exceeds free disk space (main_window.py:1722-1743).
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Optional

from ..models import VideoInfo

_BASE_MBPS = 220.0
_BASE_PIXEL_RATE = 1920 * 1080 * 29.97


def estimate_prores_bytes(info: Optional[VideoInfo]) -> Optional[int]:
    if not info or not info.duration:
        return None
    w = info.width or 1920
    h = info.height or 1080
    fps = info.fps or 29.97
    scale = max(0.1, (w * h * fps) / _BASE_PIXEL_RATE)
    mbps = _BASE_MBPS * scale
    return int(mbps * 1_000_000 / 8 * info.duration)


def free_disk_bytes(path: Path) -> int:
    return shutil.disk_usage(str(path)).free


def disk_space_warning(total_estimate: int, target_dir: Path) -> Optional[str]:
    """Reference-style pre-flight warning text, or None if space suffices."""
    try:
        free = free_disk_bytes(target_dir)
    except OSError:
        return None
    if total_estimate <= free:
        return None
    return (
        f"Estimated master size {total_estimate / 1e9:.1f} GB exceeds free "
        f"space {free / 1e9:.1f} GB in {target_dir}"
    )
