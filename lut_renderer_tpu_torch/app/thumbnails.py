"""Thumbnail cache.

Reference contract (src/lut_renderer/thumbnails.py): cache key is
SHA1("<resolved path>:<mtime_ns>") under the user cache dir's thumbs/
folder; thumbnails are first-frame JPEGs scaled to width 160 preserving
aspect. Generation goes through cv2 instead of an ffmpeg subprocess.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import Optional

from .settings import APP_NAME


def _thumb_dir() -> Path:
    env = os.environ.get("LUT_TPU_THUMB_DIR")
    if env:
        path = Path(env)
    else:
        try:
            from platformdirs import user_cache_dir

            path = Path(user_cache_dir(APP_NAME)) / "thumbs"
        except Exception:
            path = Path(os.path.expanduser("~/.cache")) / APP_NAME / "thumbs"
    path.mkdir(parents=True, exist_ok=True)
    return path


def thumb_key(source: Path) -> str:
    stat = Path(source).stat()
    key = f"{Path(source).resolve()}:{stat.st_mtime_ns}"
    return hashlib.sha1(key.encode("utf-8")).hexdigest()


def ensure_thumbnail(source, width: int = 160) -> Optional[Path]:
    import cv2

    source = Path(source)
    out = _thumb_dir() / f"{thumb_key(source)}.jpg"
    if out.exists():
        return out
    cap = cv2.VideoCapture(str(source))
    try:
        ok, frame = cap.read()
        if not ok or frame is None:
            return None
        h, w = frame.shape[:2]
        scale = width / max(1, w)
        resized = cv2.resize(frame, (width, max(1, int(round(h * scale)))))
        if not cv2.imwrite(str(out), resized, [cv2.IMWRITE_JPEG_QUALITY, 85]):
            return None
        return out
    finally:
        cap.release()
