"""ProcessingParams: the user-facing parameter namespace.

Field set, defaults, and the empty-string-means-auto convention mirror the
reference (src/lut_renderer/models.py:20-122) so presets and settings files are
interchangeable. Serialization is tolerant in both directions: unknown keys are
ignored, missing keys fall back to defaults (models.py:89-122 semantics).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict


@dataclass
class ProcessingParams:
    video_codec: str = "libx264"
    audio_codec: str = "aac"
    # Empty means "don't force"; bit-depth policy / encoder defaults decide.
    pix_fmt: str = ""
    resolution: str = ""  # empty keeps source
    bitrate: str = ""
    fps: str = ""  # empty keeps source
    crf: str = ""
    preset: str = ""
    tune: str = ""
    gop: str = ""
    profile: str = ""
    level: str = ""
    threads: str = ""
    audio_bitrate: str = ""
    sample_rate: str = ""
    channels: str = ""
    faststart: bool = False
    overwrite: bool = True
    generate_cover: bool = False
    processing_mode: str = "fast"  # "fast" | "pro"
    bit_depth_policy: str = "preserve"  # "preserve" | "auto" | "force_8bit"
    force_cfr: bool = True
    inherit_color_metadata: bool = True
    lut_interp: str = "tetrahedral"
    # "none" | "error_diffusion": exact Floyd-Steinberg via the native host
    # pass when the C extension is built, else an ordered-dither fallback
    # (engine/config.py wires the choice; plan.policy notes which ran).
    zscale_dither: str = "none"
    # YUV<->RGB matrix selection for the LUT input ("auto" | "bt709" | "none"
    # | explicit matrix name) — reference models.py:47-51.
    lut_input_matrix: str = "auto"
    # Output color tags when a LUT is applied ("bt709" | "inherit" | "none") —
    # reference models.py:52-56.
    lut_output_tags: str = "bt709"

    _BOOL_FIELDS = frozenset(
        {"faststart", "overwrite", "generate_cover", "force_cfr", "inherit_color_metadata"}
    )

    def to_dict(self) -> Dict[str, Any]:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "ProcessingParams":
        defaults = cls()
        kwargs = {}
        for f in dataclasses.fields(cls):
            value = data.get(f.name, getattr(defaults, f.name))
            if f.name in cls._BOOL_FIELDS:
                value = bool(value)
            kwargs[f.name] = value
        return cls(**kwargs)

    def copy(self) -> "ProcessingParams":
        return dataclasses.replace(self)
