"""Stage pipeline builder: Task -> ordered render stages.

Semantic port of the reference's `build_pipeline` + `_build_master_params`
(src/lut_renderer/ffmpeg.py:417-487):

  * fast mode: one stage, LUT applied, user's encode params;
  * pro mode:  stage 1 "ProRes master" — LUT applied, prores_ks profile 3,
    yuv422p10le, audio copy, cleaned up on success; stage 2 "distribution" —
    user params, NO LUT, and `probe_source=True` so policy runs against the
    real properties of the intermediate master (ffmpeg.py:23-25, 459-471).

Pro mode without an intermediate path is a hard error (ffmpeg.py:441-442).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

from ..models import ProcessingParams, Task


@dataclass
class Stage:
    name: str
    source_path: Path
    output_path: Path
    params: ProcessingParams
    lut_path: Optional[Path] = None
    cleanup_on_success: bool = False
    notes: List[str] = field(default_factory=list)
    # Probe the stage input right before planning — matters for the pro
    # pipeline where stage 2 reads an intermediate file that didn't exist at
    # queue time.
    probe_source: bool = False


def build_master_params(params: ProcessingParams) -> ProcessingParams:
    """Fixed ProRes 422 HQ mastering parameters (ffmpeg.py:417-433)."""
    master = ProcessingParams.from_dict(params.to_dict())
    master.video_codec = "prores_ks"
    master.audio_codec = "copy"
    master.pix_fmt = "yuv422p10le"
    master.profile = "3"
    master.level = ""
    master.crf = ""
    master.preset = ""
    master.tune = ""
    master.bitrate = ""
    master.audio_bitrate = ""
    master.sample_rate = ""
    master.channels = ""
    master.faststart = False
    master.bit_depth_policy = "preserve"
    return master


def build_pipeline(task: Task) -> List[Stage]:
    params = task.params

    if params.processing_mode == "pro":
        if not task.intermediate_path:
            raise ValueError(
                "Pro mastering mode requires an explicit intermediate path "
                "(set the master cache directory)."
            )
        master = Stage(
            name="ProRes master",
            source_path=task.source_path,
            output_path=task.intermediate_path,
            params=build_master_params(params),
            lut_path=task.lut_path,
            cleanup_on_success=True,
            notes=["Master fixed to ProRes 422 HQ (yuv422p10le)"],
            probe_source=False,
        )
        dist = Stage(
            name="Distribution encode",
            source_path=task.intermediate_path,
            output_path=task.output_path,
            params=params,
            lut_path=None,
            cleanup_on_success=False,
            notes=[],
            probe_source=True,
        )
        return [master, dist]

    return [
        Stage(
            name="Fast delivery",
            source_path=task.source_path,
            output_path=task.output_path,
            params=params,
            lut_path=task.lut_path,
            cleanup_on_success=False,
            notes=[],
            probe_source=False,
        )
    ]
