"""Settings persistence: one tolerant JSON file in the user config dir.

Reference contract (src/lut_renderer/settings.py): load returns {} for
missing or corrupt files; save writes indented JSON. Same keys are used by
callers (ui_theme, lut_history, last_lut, intermediate_dir, ...). The app
name is distinct ("lut-renderer-tpu") so a machine carrying the original
tool keeps separate state.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict

APP_NAME = "lut-renderer-tpu"
SETTINGS_FILE = "settings.json"


def _config_root() -> Path:
    env = os.environ.get("LUT_TPU_CONFIG_DIR")
    if env:
        return Path(env)
    try:
        from platformdirs import user_config_dir

        return Path(user_config_dir(APP_NAME))
    except Exception:
        return Path(os.path.expanduser("~/.config")) / APP_NAME


def settings_path() -> Path:
    root = _config_root()
    root.mkdir(parents=True, exist_ok=True)
    return root / SETTINGS_FILE


def load_settings() -> Dict[str, Any]:
    path = settings_path()
    if not path.exists():
        return {}
    try:
        return json.loads(path.read_text(encoding="utf-8"))
    except Exception:
        return {}


def save_settings(data: Dict[str, Any]) -> None:
    settings_path().write_text(json.dumps(data, indent=2), encoding="utf-8")
