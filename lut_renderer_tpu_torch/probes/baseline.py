"""The five BASELINE.json configurations (its ``configs``) as the port runs
them, each stage's RenderConfig derived by the policy as the task runner
derives it: ``plan.build_pipeline`` -> ``plan.build_render_spec`` -> the
encoder's pixel format (``engine.config.effective_output_pix_fmt``) ->
``engine.config.derive_render_config``. Sources are synthetic probe
results, so the host codecs stay out: ``chip_smoke.py`` drives these
stages on the card with seeded frames, and tests/test_torch_pro.py holds
the derivation to the runner's on real files."""

from __future__ import annotations

from dataclasses import replace
from pathlib import Path
from typing import List, NamedTuple, Optional

from ..engine.config import derive_render_config, effective_output_pix_fmt
from ..models import ProcessingParams, Task, VideoInfo
from ..models.video_info import infer_bit_depth
from ..ops.render import RenderConfig
from ..plan import build_pipeline, build_render_spec
from ..plan.policy import RenderSpec

LUT_PATH = Path("look.cube")


class BaselineStage(NamedTuple):
    """One render stage of a configuration: its source as probed, the spec
    and RenderConfig the policy derives, the LUT's size (None: no LUT),
    and how many frames a run drives."""

    name: str
    info: VideoInfo
    spec: RenderSpec
    cfg: RenderConfig
    lut_size: Optional[int]
    frames: int


def stage_config(params: ProcessingParams, info: Optional[VideoInfo],
                 lut_path: Optional[Path], source: Path = Path("clip.mov"),
                 output: Path = Path("clip_out.mp4"),
                 notes: Optional[list] = None):
    """(spec, cfg) of one stage, as run_stage derives them."""
    spec = build_render_spec(source, output, params, lut_path, info,
                             notes=notes)
    spec = replace(spec, pix_fmt=effective_output_pix_fmt(spec, info))
    return spec, derive_render_config(spec, info)


def master_info(spec: RenderSpec, info: VideoInfo) -> VideoInfo:
    """What a probe of the file that `spec` writes from `info` reports, on
    the fields the policy reads: the stage-2 source of a pro run."""
    tags = spec.color_tags
    return VideoInfo(width=info.width, height=info.height, fps=info.fps,
                     pix_fmt=spec.pix_fmt,
                     bit_depth=infer_bit_depth(spec.pix_fmt),
                     color_primaries=tags.primaries, color_trc=tags.trc,
                     colorspace=tags.colorspace, color_range=tags.range)


def task_stages(task: Task, probe=None) -> List[tuple]:
    """[(stage, source info, spec, cfg)] of a task's stages, as the runner
    plans them; `probe(path)` reads a stage's source where the stage asks
    for a probe (None: master_info of the stage before)."""
    out, info = [], task.source_info
    for stage in build_pipeline(task):
        if stage.probe_source:
            info = (probe(stage.source_path) if probe is not None
                    else master_info(out[-1][2], info))
        spec, cfg = stage_config(stage.params, info, stage.lut_path,
                                 stage.source_path, stage.output_path,
                                 stage.notes)
        out.append((stage, info, spec, cfg))
    return out


def _source(w: int, h: int, pix_fmt: str, codec: str, fps: float,
            **tags) -> VideoInfo:
    return VideoInfo(width=w, height=h, pix_fmt=pix_fmt,
                     bit_depth=infer_bit_depth(pix_fmt), fps=fps,
                     codec_name=codec, **tags)


BT709 = dict(colorspace="bt709", color_primaries="bt709", color_trc="bt709")


def baseline_stages() -> List[BaselineStage]:
    """The stages of BASELINE.json's configs 3 (the pro pair), 2, 5, 1 and
    4, in that order, at their published frame sizes."""
    c3 = _source(3840, 2160, "yuv422p10le", "prores", 23.976, **BT709)
    task = Task(task_id="config3", source_path=Path("clip.mov"),
                output_path=Path("clip_out.mp4"), lut_path=LUT_PATH,
                cover_path=None,
                params=ProcessingParams(processing_mode="pro"),
                source_info=c3,
                intermediate_path=Path("masters/clip_master.mov"))
    (_, i1, s1, c1), (_, i2, s2, c2) = task_stages(task)
    stages = [BaselineStage("3 pro stage 1 (master)", i1, s1, c1, 33, 16),
              BaselineStage("3 pro stage 2 (delivery)", i2, s2, c2, None,
                            16)]
    for name, info, params, n, frames in (
            ("2 1080p 65^3 10-bit -> 8-bit dither",
             _source(1920, 1080, "yuv420p10le", "hevc", 25.0, **BT709),
             ProcessingParams(bit_depth_policy="force_8bit",
                              zscale_dither="ordered"), 65, 16),
            ("5 8K 10-bit",
             _source(7680, 4320, "yuv420p10le", "hevc", 25.0, **BT709),
             ProcessingParams(video_codec="libx265"), 33, 8),
            ("1 1080p trilinear",
             _source(1920, 1080, "yuv420p", "h264", 25.0, **BT709),
             ProcessingParams(lut_interp="trilinear"), 33, 16),
            ("4 1080p full range",
             _source(1920, 1080, "yuvj420p", "mjpeg", 30.0,
                     color_range="pc"),
             ProcessingParams(), 33, 16)):
        spec, cfg = stage_config(params, info, LUT_PATH)
        stages.append(BaselineStage(name, info, spec, cfg, n, frames))
    return stages
