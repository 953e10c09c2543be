"""engine: the streaming executor of the port, decode -> device render ->
encode (counterpart of lut_renderer_tpu/engine)."""

from .config import derive_encoder_settings, derive_render_config
from .executor import StageResult, StageStats, render_batches, run_stage
from .scheduler import FrameScheduler

__all__ = [
    "derive_render_config",
    "derive_encoder_settings",
    "FrameScheduler",
    "StageResult",
    "StageStats",
    "render_batches",
    "run_stage",
]
