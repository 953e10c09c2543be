"""LUT history persistence.

Reference contract (src/lut_renderer/lut_manager.py): unbounded history list
in settings under `lut_history` with the active LUT in `last_lut`; selecting
moves a path to the head; cleanup drops entries whose files no longer exist.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

from .settings import load_settings, save_settings


def lut_history(settings: Optional[Dict] = None) -> List[str]:
    s = settings if settings is not None else load_settings()
    hist = s.get("lut_history") or []
    return [str(h) for h in hist]


def last_lut(settings: Optional[Dict] = None) -> Optional[str]:
    s = settings if settings is not None else load_settings()
    return s.get("last_lut") or None


def remember_lut(path, settings: Optional[Dict] = None, persist: bool = True) -> Dict:
    s = settings if settings is not None else load_settings()
    text = str(path)
    hist = [h for h in lut_history(s) if h != text]
    hist.insert(0, text)
    s["lut_history"] = hist
    s["last_lut"] = text
    if persist:
        save_settings(s)
    return s


def cleanup_lut_history(settings: Optional[Dict] = None, persist: bool = True) -> Dict:
    s = settings if settings is not None else load_settings()
    hist = [h for h in lut_history(s) if Path(h).exists()]
    s["lut_history"] = hist
    if s.get("last_lut") and not Path(s["last_lut"]).exists():
        s["last_lut"] = hist[0] if hist else ""
    if persist:
        save_settings(s)
    return s
