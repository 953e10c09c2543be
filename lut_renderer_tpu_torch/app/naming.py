"""Output naming contract and import helpers.

Reference behaviors carried over exactly:
  * video extension whitelist {mp4, mov, mkv, avi, mxf, webm}
    (main_window.py:76) with recursive folder import + dedup
    (main_window.py:249-303);
  * default output dir `<source dir>/output` created on demand
    (main_window.py:1746-1753);
  * output `stem_out.ext` with `_1, _2, ...` anti-collision suffixes —
    existing files are never overwritten by naming (main_window.py:1755-1762);
  * cover `stem_cover.jpg` (main_window.py:1764-1771);
  * intermediate master `stem_master.mov` in the user-chosen cache dir
    (main_window.py:1773-1784).
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, List

VIDEO_EXTS = {".mp4", ".mov", ".mkv", ".avi", ".mxf", ".webm"}


def collect_video_files(paths: Iterable[Path]) -> List[Path]:
    """Expand files/dirs (recursive) into a deduplicated ordered list of
    video files by extension."""
    seen = set()
    out: List[Path] = []

    def add(p: Path):
        key = str(p.resolve())
        if key not in seen and p.suffix.lower() in VIDEO_EXTS:
            seen.add(key)
            out.append(p)

    for path in paths:
        path = Path(path)
        if path.is_dir():
            for child in sorted(path.rglob("*")):
                if child.is_file():
                    add(child)
        elif path.is_file():
            add(path)
    return out


def default_output_dir(source: Path) -> Path:
    out = Path(source).parent / "output"
    out.mkdir(parents=True, exist_ok=True)
    return out


def _dedup(path: Path) -> Path:
    if not path.exists():
        return path
    stem, suffix = path.stem, path.suffix
    counter = 1
    while True:
        candidate = path.with_name(f"{stem}_{counter}{suffix}")
        if not candidate.exists():
            return candidate
        counter += 1


def output_path_for(source: Path, out_dir: Path, container: str = None) -> Path:
    source = Path(source)
    ext = f".{container.lstrip('.')}" if container else source.suffix
    return _dedup(Path(out_dir) / f"{source.stem}_out{ext}")


def cover_path_for(source: Path, out_dir: Path) -> Path:
    return _dedup(Path(out_dir) / f"{Path(source).stem}_cover.jpg")


def intermediate_path_for(source: Path, cache_dir: Path) -> Path:
    return _dedup(Path(cache_dir) / f"{Path(source).stem}_master.mov")
