"""Named parameter snapshots persisted as JSON, one file per preset.

Keeps the reference's observable contract (config tier (b) of SURVEY.md §5.6,
reference: src/lut_renderer/presets.py) — presets live in
``<config>/presets/<name>.json``, creating over an existing name raises
``FileExistsError`` so callers can confirm, renaming refuses to clobber, and
bulk loading tolerates corrupt files — but the storage layer is this
framework's own design:

* every write is **atomic** (temp file in the same directory, fsync, then
  ``os.replace``) so a crash mid-save can never leave a truncated preset;
* preset names are validated (no path separators / traversal, non-empty)
  before touching the filesystem;
* errors carry a small taxonomy rooted at :class:`PresetError`, with the
  lookup/conflict classes double-inheriting the builtin ``FileNotFoundError``
  / ``FileExistsError`` so existing ``except`` sites keep working.
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Dict, List

from ..models import ProcessingParams
from . import settings as _settings


class PresetError(Exception):
    """Base class for preset-store failures."""


class PresetNameError(PresetError, ValueError):
    """The preset name cannot be used as a filename."""


class PresetMissingError(PresetError, FileNotFoundError):
    """No preset stored under that name."""


class PresetExistsError(PresetError, FileExistsError):
    """A preset already occupies that name (caller must opt into overwrite)."""


def presets_dir() -> Path:
    # Late-bound through the settings module so tests can redirect the
    # config root after import.
    root = _settings._config_root() / "presets"
    root.mkdir(parents=True, exist_ok=True)
    return root


def _path_for(name: str) -> Path:
    if not name or name != name.strip():
        raise PresetNameError(f"unusable preset name: {name!r}")
    if any(sep in name for sep in ("/", "\\", "\0")) or name in (".", ".."):
        raise PresetNameError(f"unusable preset name: {name!r}")
    return presets_dir() / f"{name}.json"


def _atomic_write_json(path: Path, payload: dict) -> None:
    """Write JSON via temp-file + rename so readers never see a partial file."""
    fd, tmp = tempfile.mkstemp(
        prefix=f".{path.stem}.", suffix=".tmp", dir=str(path.parent)
    )
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def list_presets() -> List[str]:
    return sorted(
        p.stem for p in presets_dir().glob("*.json") if not p.name.startswith(".")
    )


def load_preset(name: str) -> ProcessingParams:
    path = _path_for(name)
    try:
        raw = path.read_text(encoding="utf-8")
    except FileNotFoundError:
        raise PresetMissingError(f"no preset stored as {name!r}") from None
    return ProcessingParams.from_dict(json.loads(raw))


def save_preset(name: str, params: ProcessingParams) -> Path:
    """Store a new preset; refuses to replace one (PresetExistsError, an
    alias of FileExistsError) so interactive callers can confirm first."""
    path = _path_for(name)
    if path.exists():
        raise PresetExistsError(f"preset {name!r} already stored; overwrite?")
    _atomic_write_json(path, params.to_dict())
    return path


def overwrite_preset(name: str, params: ProcessingParams) -> Path:
    path = _path_for(name)
    _atomic_write_json(path, params.to_dict())
    return path


def delete_preset(name: str) -> None:
    try:
        _path_for(name).unlink()
    except FileNotFoundError:
        pass


def rename_preset(old: str, new: str) -> Path:
    src = _path_for(old)
    dst = _path_for(new)
    if not src.exists():
        raise PresetMissingError(f"no preset stored as {old!r}")
    if dst.exists():
        raise PresetExistsError(f"preset {new!r} already stored")
    os.replace(src, dst)
    return dst


def load_all_presets() -> Dict[str, ProcessingParams]:
    """Every loadable preset; files that fail to parse are skipped (a corrupt
    preset must never take down the whole catalog)."""
    out: Dict[str, ProcessingParams] = {}
    for name in list_presets():
        try:
            out[name] = load_preset(name)
        except (OSError, ValueError):
            continue
    return out
