"""app — user-facing surface: persistence, naming, defaults, CLI.

Mirrors the reference's L4/Lx behaviors that aren't GUI pixels: output naming
contract, presets/settings JSON tiers, LUT history, thumbnail cache, smart
parameter defaults, ProRes disk estimation. The interactive shell is a
headless CLI (`lut-tpu`) rather than a Qt window — PySide6 isn't part of the
pixel path and isn't present in this environment (SURVEY.md §7.7)."""

from .naming import (
    VIDEO_EXTS,
    collect_video_files,
    cover_path_for,
    default_output_dir,
    intermediate_path_for,
    output_path_for,
)
from .estimate import estimate_prores_bytes
from .settings import load_settings, save_settings, settings_path
from .presets import (
    delete_preset,
    list_presets,
    load_all_presets,
    load_preset,
    overwrite_preset,
    rename_preset,
    save_preset,
)
from .lut_history import remember_lut, lut_history, cleanup_lut_history, last_lut
from .thumbnails import ensure_thumbnail
from .defaults import apply_smart_defaults, mode_template

__all__ = [
    "VIDEO_EXTS",
    "collect_video_files",
    "cover_path_for",
    "default_output_dir",
    "intermediate_path_for",
    "output_path_for",
    "estimate_prores_bytes",
    "load_settings",
    "save_settings",
    "settings_path",
    "delete_preset",
    "list_presets",
    "load_all_presets",
    "load_preset",
    "overwrite_preset",
    "rename_preset",
    "save_preset",
    "remember_lut",
    "lut_history",
    "cleanup_lut_history",
    "last_lut",
    "ensure_thumbnail",
    "apply_smart_defaults",
    "mode_template",
]
